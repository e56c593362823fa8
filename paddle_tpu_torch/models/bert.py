"""BERT — bidirectional transformer encoder (port of
``paddle_tpu.models.bert``).

Same module tree and parameter names as the JAX package
(``bert.layers.0.attn.qkv.weight`` …, Linear weights ``[in, out]``), so
:func:`paddle_tpu_torch.bridge.load_jax_params` maps JAX weights 1:1.
Post-LN layers run both residual adds + LayerNorms through the
hand-written ``layernorm_residual`` CUDA kernel on the card, and the MLM
loss through ``softmax_cross_entropy``; on the CPU both take their plain
PyTorch versions.  The MLP is GPT's ``ParallelMLP`` at BERT's
``intermediate_size``, as in the JAX package, or with
``BertConfig.moe_experts > 0`` a ``moe.MoELayer`` built from the same
``GPTConfig`` the JAX layer builds (its expert FFNs through the
``grouped_matmul`` kernel on the card; the loss adds no balance term, as
in JAX).  ``BertConfig.quantization="int8" | "fp8"`` quantizes the
parallel linears (attention ``qkv`` / ``out``, the MLP's ``fc1`` /
``fc2``) once the weights are drawn (``slim.quantize_weights``: the
``quantized_matmul`` kernel on the card); the heads stay float.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .. import nn
from ..distributed.meta_parallel import (
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
)
from ..framework.device import resolve_device
from ..framework.dtype import convert_dtype, promote
from ..framework.random import default_generator
from ..nn.functional import cross_entropy
from ..nn.initializer import fills_its_layers
from ..ops.fused_layernorm import layernorm_residual
from ..ops.fused_softmax_xent import softmax_cross_entropy
from ..moe import MoELayer
from .gpt import GPTConfig, ParallelMLP

__all__ = [
    "BertConfig",
    "BertModel",
    "BertForPretraining",
    "BertForSequenceClassification",
    "BertForQuestionAnswering",
    "bert_base",
    "bert_tiny",
]


class BertConfig:
    def __init__(self, vocab_size=30522, hidden_size=768, num_layers=12,
                 num_heads=12, intermediate_size=3072, max_position=512,
                 type_vocab_size=2, dropout=0.1, layer_norm_epsilon=1e-12,
                 dtype="float32", moe_experts=0, moe_top_k=2,
                 moe_capacity_factor=1.25, moe_jitter=0.01,
                 quantization="none"):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.intermediate_size = intermediate_size
        self.max_position = max_position
        self.type_vocab_size = type_vocab_size
        self.dropout = dropout
        self.layer_norm_epsilon = layer_norm_epsilon
        self.dtype = dtype
        #: > 0 swaps each layer's dense MLP for a routed MoELayer with
        #: that many experts (knobs as GPTConfig's)
        self.moe_experts = moe_experts
        self.moe_top_k = moe_top_k
        self.moe_capacity_factor = moe_capacity_factor
        self.moe_jitter = moe_jitter
        #: "none" | "int8" | "fp8" — weight quantization of the parallel
        #: linears (GPTConfig.quantization's contract)
        if quantization not in ("none", "int8", "fp8"):
            raise ValueError(
                f"quantization must be 'none', 'int8' or 'fp8', got "
                f"{quantization!r}")
        self.quantization = quantization


def bert_base(**kw):
    return BertConfig(**kw)


def bert_tiny(**kw):
    cfg = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
               intermediate_size=64, max_position=64, dropout=0.0)
    cfg.update(kw)
    return BertConfig(**cfg)


def _materialize(model: torch.nn.Module, cfg: BertConfig, device,
                 generator: Optional[torch.Generator]):
    """Draw every weight from ``generator`` (default: the CPU generator
    :func:`paddle_tpu_torch.seed` reseeds) in module order on the CPU, then
    move to ``device`` (``None`` = the card) in ``cfg.dtype``; quantize the
    parallel linears when ``cfg.quantization`` asks (the JAX ``BertModel``
    quantizes at init)."""
    dev = resolve_device(device)
    gen = generator if generator is not None else default_generator()
    for m in model.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(gen)
    model.to(device=dev, dtype=convert_dtype(cfg.dtype))
    if cfg.quantization != "none":
        # lazy import: slim imports the layers this module builds on
        from ..slim.quantization import quantize_weights

        quantize_weights(model, cfg.quantization)


class BertSelfAttention(nn.Layer):
    """Bidirectional multi-head attention (single device: heads
    unsharded)."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        d, h = cfg.hidden_size, cfg.num_heads
        self.num_heads = h
        self.head_dim = d // h
        self.qkv = ColumnParallelLinear(d, 3 * d)
        self.out = RowParallelLinear(d, d)
        self.drop = nn.Dropout(cfg.dropout)

    def forward(self, x, attn_mask=None):
        B, S, D = x.shape
        qkv = self.qkv(x).reshape(B, S, 3, self.num_heads, self.head_dim)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(
            self.head_dim)
        if attn_mask is not None:
            # the additive mask in the scores' dtype: a float32 mask would
            # promote bf16 scores (and the softmax) to float32
            scores = scores + attn_mask.to(scores.dtype)
        probs = self.drop(torch.softmax(scores, dim=-1))
        ctx = torch.einsum("bhqk,bhkd->bhqd", probs, v)
        return self.out(ctx.transpose(1, 2).reshape(B, S, D))


class BertLayer(nn.Layer):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        gcfg = GPTConfig(hidden_size=cfg.hidden_size,
                         intermediate_size=cfg.intermediate_size,
                         dropout=cfg.dropout,
                         moe_experts=cfg.moe_experts,
                         moe_top_k=cfg.moe_top_k,
                         moe_capacity_factor=cfg.moe_capacity_factor,
                         moe_jitter=cfg.moe_jitter)
        self.attn = BertSelfAttention(cfg)
        self.ln1 = nn.LayerNorm(cfg.hidden_size,
                                epsilon=cfg.layer_norm_epsilon)
        self.mlp = MoELayer(gcfg) if gcfg.moe_experts else ParallelMLP(gcfg)
        self.ln2 = nn.LayerNorm(cfg.hidden_size,
                                epsilon=cfg.layer_norm_epsilon)
        self.drop = nn.Dropout(cfg.dropout)

    def forward(self, x, attn_mask=None):
        # post-LN (original BERT): LN(x + sublayer(x)), each residual add
        # and LayerNorm one layernorm_residual call (the fused form of the
        # JAX layer)
        _, x = layernorm_residual(self.drop(self.attn(x, attn_mask)), x,
                                  self.ln1.weight, self.ln1.bias,
                                  epsilon=self.ln1.epsilon)
        _, x = layernorm_residual(self.mlp(x), x, self.ln2.weight,
                                  self.ln2.bias, epsilon=self.ln2.epsilon)
        return x


class BertEmbeddings(nn.Layer):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.word = VocabParallelEmbedding(cfg.vocab_size, cfg.hidden_size)
        self.position = nn.Embedding(cfg.max_position, cfg.hidden_size,
                                     std=0.02)
        self.token_type = nn.Embedding(cfg.type_vocab_size,
                                       cfg.hidden_size, std=0.02)
        self.ln = nn.LayerNorm(cfg.hidden_size,
                               epsilon=cfg.layer_norm_epsilon)
        self.drop = nn.Dropout(cfg.dropout)

    def forward(self, input_ids, token_type_ids=None):
        S = input_ids.shape[1]
        pos = torch.arange(S, device=input_ids.device)[None, :]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = (self.word(input_ids) + self.position(pos)
             + self.token_type(token_type_ids))
        return self.drop(self.ln(x))


def _as_ids(t, device):
    return torch.as_tensor(t, device=device).long()


class BertModel(nn.Layer):
    """The encoder: embeddings, ``num_layers`` post-LN layers and the
    tanh pooler over the first token.

    ``device`` — ``None`` runs on the CUDA card (raises
    ``UnavailableError`` when there is none), ``"cpu"`` on the CPU.
    ``generator`` — the ``torch.Generator`` the weights are drawn from
    (default: the one :func:`paddle_tpu_torch.seed` reseeds)."""

    @fills_its_layers
    def __init__(self, cfg: BertConfig, device=None,
                 generator: Optional[torch.Generator] = None, *,
                 _materialize_now: bool = True):
        super().__init__()
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg)
        self.layers = torch.nn.ModuleList(
            [BertLayer(cfg) for _ in range(cfg.num_layers)])
        self.pooler = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.pooler_act = nn.Tanh()
        if _materialize_now:
            _materialize(self, cfg, device, generator)

    @property
    def device(self) -> torch.device:
        return self.embeddings.word.weight.device

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        """attention_mask: ``[B, S]`` with 1 = attend, 0 = pad."""
        dev = self.device
        input_ids = _as_ids(input_ids, dev)
        if token_type_ids is not None:
            token_type_ids = _as_ids(token_type_ids, dev)
        x = self.embeddings(input_ids, token_type_ids)
        mask = None
        if attention_mask is not None:
            am = torch.as_tensor(attention_mask, device=dev).to(x.dtype)
            mask = ((1.0 - am) * -1e9)[:, None, None, :]  # [B,1,1,S]
        for layer in self.layers:
            x = layer(x, mask)
        pooled = self.pooler_act(self.pooler(x[:, 0]))
        return x, pooled


class BertForPretraining(nn.Layer):
    """MLM (decoder tied to the word embedding, no bias) + NSP heads."""

    @fills_its_layers
    def __init__(self, cfg: BertConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.bert = BertModel(cfg, _materialize_now=False)
        self.transform = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.act = nn.GELU()
        self.ln = nn.LayerNorm(cfg.hidden_size,
                               epsilon=cfg.layer_norm_epsilon)
        self.nsp = nn.Linear(cfg.hidden_size, 2)
        _materialize(self, cfg, device, generator)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                masked_positions=None):
        """``masked_positions`` ``[B, P]`` (integer): only the masked
        tokens go through the vocabulary projection, as MLM pretraining
        does.  Returns ``(mlm_logits [B, P, V], nsp_logits [B, 2])``."""
        seq, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        if masked_positions is not None:
            idx = _as_ids(masked_positions, seq.device)
            seq = torch.take_along_dim(seq, idx[..., None], dim=1)  # [B,P,D]
        h = self.ln(self.act(self.transform(seq)))
        # the tied decoder: under amp O2 the table is bf16 beside the
        # black-listed LayerNorm's float32 h; jnp.einsum promotes
        mlm_logits = torch.matmul(*promote(
            h, self.bert.embeddings.word.weight.t()))
        return mlm_logits, self.nsp(pooled)

    def loss(self, mlm_logits, nsp_logits, mlm_labels, nsp_labels,
             ignore_index: int = -100):
        """Masked-LM cross entropy (mean over the labels that are not
        ``ignore_index``, through :func:`softmax_cross_entropy`) plus the
        NSP cross entropy."""
        labels = _as_ids(mlm_labels, mlm_logits.device)
        ignored = labels == ignore_index
        safe = torch.where(ignored, torch.zeros_like(labels), labels)
        mask32 = (~ignored).to(torch.float32).reshape(-1)
        V = mlm_logits.shape[-1]
        per = softmax_cross_entropy(mlm_logits.reshape(-1, V),
                                    safe.reshape(-1))
        mlm_loss = (per * mask32).sum() / mask32.sum().clamp_min(1.0)
        nsp_logp = torch.log_softmax(nsp_logits, dim=-1)
        nsp = _as_ids(nsp_labels, nsp_logits.device).reshape(-1, 1)
        nsp_loss = -torch.gather(nsp_logp, 1, nsp).mean()
        return mlm_loss + nsp_loss


class BertForQuestionAnswering(nn.Layer):
    """Extractive-QA (SQuAD) head: per-token start/end logits."""

    @fills_its_layers
    def __init__(self, cfg: BertConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.bert = BertModel(cfg, _materialize_now=False)
        self.qa_outputs = nn.Linear(cfg.hidden_size, 2)
        _materialize(self, cfg, device, generator)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        seq, _ = self.bert(input_ids, token_type_ids, attention_mask)
        logits = self.qa_outputs(seq)                    # [B, S, 2]
        return logits[..., 0], logits[..., 1]            # [B, S] each

    @staticmethod
    def loss(start_logits, end_logits, start_pos, end_pos):
        """Mean of the start/end cross entropies; positions outside the
        sequence (answers truncated away) are ignored."""
        S = start_logits.shape[-1]

        def prep(pos):
            pos = _as_ids(pos, start_logits.device).reshape(-1)
            return torch.where((pos < 0) | (pos >= S),
                               torch.full_like(pos, -100), pos)

        return 0.5 * (cross_entropy(start_logits.float(), prep(start_pos))
                      + cross_entropy(end_logits.float(), prep(end_pos)))


class BertForSequenceClassification(nn.Layer):
    @fills_its_layers
    def __init__(self, cfg: BertConfig, num_classes: int = 2, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.bert = BertModel(cfg, _materialize_now=False)
        self.drop = nn.Dropout(cfg.dropout)
        self.classifier = nn.Linear(cfg.hidden_size, num_classes)
        _materialize(self, cfg, device, generator)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        _, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        return self.classifier(self.drop(pooled))
