"""Transformer layers — port of ``paddle_tpu.nn.transformer``:
``MultiHeadAttention``, the encoder and decoder layers and stacks, and
``Transformer``, with the JAX package's parameter names, post-LN by
default (``normalize_before=True``: pre-LN) and its defaults
(Transformer-base: d_model 512, 8 heads, 6 + 6 layers, 2048, dropout 0.1,
ReLU).

Attention goes through the port's ``F.scaled_dot_product_attention``:
without a mask and without attention dropout, sequences of 4096 or more
(multiples of 128) at head_dim 64 / 128 / 256 on the card take the
flash-attention kernels (forward, and the dq and dk / dv kernels as its
backward); everything else takes the dense path.  Masks follow paddle: a
bool mask is True where a query may attend, a float mask is added to the
logits (cast to the queries' dtype).  ``generate_square_subsequent_mask``
is such a bool mask (lower triangle True), not torch's float ``-inf``
one.

``TransformerEncoder`` / ``TransformerDecoder`` stack the layer they are
given and deep copies of it, so every layer starts from the same weights,
as in the JAX package; the copies draw nothing.

Incremental decoding: ``MultiHeadAttention(..., cache=(k, v))`` appends
this call's keys and values to the cache and returns ``(out, new_cache)``
(``gen_cache`` starts an empty one).  ``TransformerDecoderLayer`` and
``TransformerDecoder`` take a self-attention ``cache`` too (one per layer
for the stack; ``gen_cache(memory)`` starts them) and then return
``(out, new_cache)``; the JAX package's decoder layers accept ``cache``
and ignore it (ROADMAP §C).
"""
from __future__ import annotations

import copy

import torch

from ..tensor._common import t as _t
from .common import Dropout, Linear
from .container import LayerList
from .functional import activation as _A
from .functional.attention import scaled_dot_product_attention
from .layer import Layer
from .norm import LayerNorm

__all__ = [
    "MultiHeadAttention", "TransformerEncoderLayer", "TransformerEncoder",
    "TransformerDecoderLayer", "TransformerDecoder", "Transformer",
]


def _convert_attn_mask(mask, like):
    """A bool mask as it is; any other mask in ``like``'s dtype; both on
    its device."""
    if mask is None:
        return None
    mask = _t(mask, like).to(like.device)
    return mask if mask.dtype == torch.bool else mask.to(like.dtype)


class MultiHeadAttention(Layer):
    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        self.head_dim = embed_dim // num_heads
        kdim = kdim or embed_dim
        vdim = vdim or embed_dim
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)
        self.k_proj = Linear(kdim, embed_dim, weight_attr, bias_attr)
        self.v_proj = Linear(vdim, embed_dim, weight_attr, bias_attr)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)

    def _shape(self, x):
        b, s, _ = x.shape  # [B, S, E] -> [B, S, H, hd]
        return x.reshape(b, s, self.num_heads, self.head_dim)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        query = _t(query)
        key = query if key is None else _t(key, query)
        value = key if value is None else _t(value, query)
        q = self._shape(self.q_proj(query))
        k = self._shape(self.k_proj(key))
        v = self._shape(self.v_proj(value))
        if cache is not None:
            pk, pv = cache
            k = torch.cat([pk.to(k.dtype), k], 1)
            v = torch.cat([pv.to(v.dtype), v], 1)
        out = scaled_dot_product_attention(
            q, k, v, attn_mask=_convert_attn_mask(attn_mask, q),
            dropout_p=self.dropout, training=self.training)
        b, s = out.shape[:2]
        out = self.out_proj(out.reshape(b, s, self.embed_dim))
        return out if cache is None else (out, (k, v))

    def gen_cache(self, key, value=None, type=None):
        """An empty decode cache ``(k, v)``, each ``[B, 0, heads,
        head_dim]`` in key's dtype and on its device."""
        key = _t(key)
        empty = key.new_zeros((key.shape[0], 0, self.num_heads,
                               self.head_dim))
        return (empty, empty)


class TransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5):
        super().__init__()
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(
            d_model, nhead,
            dropout=attn_dropout if attn_dropout is not None else dropout,
            weight_attr=weight_attr, bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr)
        self.norm1 = LayerNorm(d_model, epsilon=layer_norm_eps)
        self.norm2 = LayerNorm(d_model, epsilon=layer_norm_eps)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.act_dropout = Dropout(act_dropout if act_dropout is not None
                                   else dropout)
        self.activation = activation

    def _act(self, x):
        return getattr(_A, self.activation)(x)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        x = self.norm1(src) if self.normalize_before else src
        x = self.self_attn(x, attn_mask=src_mask)
        x = residual + self.dropout1(x)
        if not self.normalize_before:
            x = self.norm1(x)
        residual = x
        y = self.norm2(x) if self.normalize_before else x
        y = self.linear2(self.act_dropout(self._act(self.linear1(y))))
        y = residual + self.dropout2(y)
        if not self.normalize_before:
            y = self.norm2(y)
        return y


class TransformerEncoder(Layer):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(
            [encoder_layer] + [copy.deepcopy(encoder_layer)
                               for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None):
        out = src
        for layer in self.layers:
            out = layer(out, src_mask=src_mask)
        if self.norm is not None:
            out = self.norm(out)
        return out


class TransformerDecoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5):
        super().__init__()
        self.normalize_before = normalize_before
        ad = attn_dropout if attn_dropout is not None else dropout
        self.self_attn = MultiHeadAttention(d_model, nhead, dropout=ad,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr)
        self.cross_attn = MultiHeadAttention(d_model, nhead, dropout=ad,
                                             weight_attr=weight_attr,
                                             bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr)
        self.norm1 = LayerNorm(d_model, epsilon=layer_norm_eps)
        self.norm2 = LayerNorm(d_model, epsilon=layer_norm_eps)
        self.norm3 = LayerNorm(d_model, epsilon=layer_norm_eps)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.act_dropout = Dropout(act_dropout if act_dropout is not None
                                   else dropout)
        self.activation = activation

    def _act(self, x):
        return getattr(_A, self.activation)(x)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        x = self.norm1(tgt) if self.normalize_before else tgt
        if cache is None:
            x = self.self_attn(x, attn_mask=tgt_mask)
        else:
            x, cache = self.self_attn(x, attn_mask=tgt_mask, cache=cache)
        x = residual + self.dropout1(x)
        if not self.normalize_before:
            x = self.norm1(x)
        residual = x
        y = self.norm2(x) if self.normalize_before else x
        y = self.cross_attn(y, memory, memory, attn_mask=memory_mask)
        y = residual + self.dropout2(y)
        if not self.normalize_before:
            y = self.norm2(y)
        residual = y
        z = self.norm3(y) if self.normalize_before else y
        z = self.linear2(self.act_dropout(self._act(self.linear1(z))))
        z = residual + self.dropout3(z)
        if not self.normalize_before:
            z = self.norm3(z)
        return z if cache is None else (z, cache)

    def gen_cache(self, memory):
        """An empty self-attention cache for decoding against
        ``memory``."""
        return self.self_attn.gen_cache(memory)


class TransformerDecoder(Layer):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(
            [decoder_layer] + [copy.deepcopy(decoder_layer)
                               for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        out = tgt
        new_cache = []
        for i, layer in enumerate(self.layers):
            if cache is None:
                out = layer(out, memory, tgt_mask=tgt_mask,
                            memory_mask=memory_mask)
            else:
                out, c = layer(out, memory, tgt_mask=tgt_mask,
                               memory_mask=memory_mask, cache=cache[i])
                new_cache.append(c)
        if self.norm is not None:
            out = self.norm(out)
        return out if cache is None else (out, new_cache)

    def gen_cache(self, memory):
        return [layer.gen_cache(memory) for layer in self.layers]


class Transformer(Layer):
    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None):
        super().__init__()
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            enc_layer = TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
            enc_norm = LayerNorm(d_model) if normalize_before else None
            self.encoder = TransformerEncoder(enc_layer, num_encoder_layers,
                                              enc_norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            dec_layer = TransformerDecoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
            dec_norm = LayerNorm(d_model) if normalize_before else None
            self.decoder = TransformerDecoder(dec_layer, num_decoder_layers,
                                              dec_norm)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask=src_mask)
        return self.decoder(tgt, memory, tgt_mask=tgt_mask,
                            memory_mask=memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length):
        """``[length, length]`` bool, True on and below the diagonal (on
        the CPU; attention moves it to the queries' device)."""
        return torch.ones(length, length, dtype=torch.bool).tril()
