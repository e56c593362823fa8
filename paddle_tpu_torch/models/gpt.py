"""GPT — decoder-only transformer LM (port of ``paddle_tpu.models.gpt``).

Same module tree and parameter names as the JAX package
(``gpt.blocks.0.attn.qkv.weight`` …, Linear weights ``[in, out]``), so
:func:`paddle_tpu_torch.bridge.load_jax_params` maps JAX weights 1:1.

Ported: the dense causal :meth:`GPTForCausalLM.forward` with the training
loss :meth:`GPTForCausalLM.loss`, and the paged-KV serving path
(:meth:`GPTModel.init_paged_cache` / :meth:`copy_pages` /
:meth:`forward_paged`), with int8 / fp8-e4m3 weights
(``GPTConfig.quantization``, ``slim.quantize_weights``) and int8 / fp8
KV pools (``init_paged_cache(dtype=)``: quantize on write, one scale per
written token per head in ``[P+1, H, page]`` float32 planes, dequantize
in the attention kernel), and mixture-of-experts blocks
(``GPTConfig.moe_experts``: every block's MLP a ``moe.MoELayer``, its
load-balance loss added by :meth:`GPTForCausalLM.loss`; with
``quantization`` too, only the attention's ``qkv`` / ``out`` are
quantized and the experts stay float, as in the JAX package).  The
hand-written CUDA kernels on the card: ``layernorm_residual`` (the
attention residual add + ``ln2`` of every block's dense forward),
``softmax_cross_entropy`` (the loss), ``grouped_matmul`` (both expert
matmuls of every MoE block),
``flash_attention`` (the dense forward's attention at S >= 4096,
:meth:`ParallelAttention._use_flash`; its backward is the dq and dk / dv
kernels, so ``train_batch`` at long context never builds ``[B, H, S, S]``
scores), ``paged_flash_decode``
(paged attention, behind ``paged_flash_eligible`` as in the JAX package;
off it the gather-then-attend path) and ``quantized_matmul`` (every
quantized ``qkv`` / ``out`` / ``fc1`` / ``fc2``).  The paged pool is
updated IN PLACE (JAX returns new arrays): ``forward_paged`` scatters into
the tensors of ``cache`` and returns the same dict, which saves one pool
copy per layer per step.  The dense ring KV cache of the default serving
engine (:meth:`GPTModel.init_cache` / :meth:`~GPTModel.reset_slots` /
:meth:`~GPTModel.write_slots` and ``forward_cached`` at every level) is
updated in place the same way: the new tokens' K/V are written by index
(``positions % C``, ``-1`` skipped) where JAX multiplies a one-hot ``hit``
into the whole ring and merges with ``jnp.where`` — the same values, since
a one-hot product with 1.0 is exact.  Its attention is the JAX einsum /
softmax (no kernel: it is plain XLA in JAX too).  The prefill→decode
hand-off moves pages through :meth:`GPTModel.gather_pages` /
:meth:`~GPTModel.scatter_pages` as one host array.  ``GPTConfig.lora_capacity
> 0`` registers batched multi-LoRA adapter tables on every block projection
(``lora.enable_lora``); ``forward_cached`` / ``forward_paged`` take per-row
``adapter_ids`` and scope them around the block stack, each adapted linear
adding its delta through two ``grouped_matmul`` launches on the card.

Tensor parallelism (a ``model`` mesh axis, ``fleet.ShardingPlan``
placing the weights): ``qkv`` is column-parallel over 3 fused blocks, so
a rank computes its ``H / mp`` heads; ``out`` and ``fc2`` are
row-parallel (one all-reduce each); the tied LM head multiplies by this
rank's vocabulary rows and gathers the logits to the whole vocabulary
before the loss, so ``softmax_cross_entropy`` sees whole rows.
``GPTConfig.sequence_parallel`` ("ring" / "ulysses") runs each block's
attention on this rank's sequence chunk over the ``sep`` axis
(``distributed.sequence_parallel``: kernel 4 forward and kernels 5-6
backward per ring chunk on the card); the rest of the block runs on the
whole sequence, as the JAX package's GSPMD step leaves it.  Not ported
yet (ROADMAP queue A): pipeline parallelism, and serving at ``mp > 1``.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import numpy as np
import torch

from .. import nn
from ..distributed.meta_parallel import (
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
)
from ..framework.device import resolve_device, upload
from ..framework.dtype import RAW_BITS, promote
from ..framework.errors import InvalidArgumentError, UnimplementedError
from ..framework.random import default_generator
from ..moe import MoELayer
from ..nn.initializer import fills_its_layers
from ..moe import stats as moe_stats
from ..ops.fused_layernorm import layernorm_residual
from ..ops.fused_softmax_xent import softmax_cross_entropy
from ..ops.flash_attention import HEAD_DIMS as FLASH_HEAD_DIMS
from ..ops.flash_attention import flash_attention
from ..ops.paged_attention import paged_flash_decode, paged_flash_eligible

__all__ = ["GPTConfig", "GPTModel", "GPTForCausalLM", "gpt_tiny",
           "gpt_small"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
#: what ``init_paged_cache(dtype=)`` takes: the float dtypes, and the
#: quantized pool dtypes by torch dtype or by name
_POOL_DTYPES = dict(_DTYPES, int8=torch.int8,
                    float8_e4m3fn=torch.float8_e4m3fn)
_QUANT_POOL_DTYPES = (torch.int8, torch.float8_e4m3fn)


def _quantize_kv(t, qdtype):
    """Quantize-on-write for paged KV: ``t`` float ``[N, H, hd]`` →
    (quantized values, ``[N, H]`` float32 dequant multipliers), one
    abs-max scale per written token per head."""
    tf = t.float()
    amax = tf.abs().amax(dim=-1).clamp_min(1e-9)  # [N, H]
    fp8_max = 448.0  # largest finite e4m3fn; clip BEFORE the cast
    # tensor / tensor: an IEEE division on both devices (a Python scalar
    # on either side becomes a multiply by a reciprocal, an ulp off)
    top = torch.full_like(amax, 127.0 if qdtype == torch.int8 else fp8_max)
    ratio = (top / amax)[..., None]
    if qdtype == torch.int8:
        q = torch.clamp(torch.round(tf * ratio), -127, 127).to(torch.int8)
    else:
        q = torch.clamp(tf * ratio, -fp8_max, fp8_max).to(
            torch.float8_e4m3fn)
    return q, amax / top


def _host_ints(a) -> np.ndarray:
    """``a`` (numpy, a list or a tensor on any device) as host int64 —
    the engines pass host arrays, so only a caller handing over a card
    tensor pays a device sync here."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a).astype(np.int64)


def _host_bool(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, bool).reshape(-1)


def _from_host(a, dtype: torch.dtype, device) -> torch.Tensor:
    """A hand-off payload array on ``device`` as ``dtype``: raw bits
    (``RAW_BITS``, as :meth:`GPTModel.gather_pages` exports fp8 / bf16)
    are reinterpreted, bit for bit; any other array is cast, as JAX's
    ``astype`` casts it."""
    t = upload(a, device)
    raw = RAW_BITS.get(dtype)
    if raw is not None and t.dtype == raw[0]:
        return t.view(dtype)
    return t.to(dtype)


class GPTConfig:
    def __init__(self, vocab_size=50304, hidden_size=768, num_layers=12,
                 num_heads=12, intermediate_size=None, max_position=1024,
                 dropout=0.1, layer_norm_epsilon=1e-5, dtype="float32",
                 sequence_parallel=None, moe_experts=0, moe_top_k=2,
                 moe_capacity_factor=1.25, moe_jitter=0.01,
                 moe_balance_weight=0.01, quantization="none",
                 lora_capacity=0, lora_rank=8, lora_alpha=16.0):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.intermediate_size = intermediate_size or 4 * hidden_size
        self.max_position = max_position
        self.dropout = dropout
        self.layer_norm_epsilon = layer_norm_epsilon
        self.dtype = dtype
        #: "ring" / "ulysses": attention over the ``sep`` mesh axis
        #: (see distributed/sequence_parallel.py)
        self.sequence_parallel = sequence_parallel
        #: > 0 swaps every block's dense ParallelMLP for a
        #: ``moe.MoELayer`` with that many experts (top ``moe_top_k``
        #: routing, ``moe_capacity_factor`` slots, ``moe_jitter`` on the
        #: gate input in training)
        self.moe_experts = moe_experts
        self.moe_top_k = moe_top_k
        self.moe_capacity_factor = moe_capacity_factor
        self.moe_jitter = moe_jitter
        #: multiplier on the summed per-layer load-balance loss added to
        #: :meth:`GPTForCausalLM.loss`
        self.moe_balance_weight = moe_balance_weight
        #: "none" | "int8" | "fp8" — serving weight quantization: the
        #: parallel-linear weights are quantized in place when
        #: ``GPTForCausalLM`` is built (``slim.quantize_weights``)
        if quantization not in ("none", "int8", "fp8"):
            raise ValueError(
                f"quantization must be 'none', 'int8' or 'fp8', got "
                f"{quantization!r}")
        self.quantization = quantization
        #: > 0 registers fixed-capacity batched multi-LoRA adapter tables
        #: on every block projection (``lora.enable_lora``): that many
        #: hot-swappable adapter slots a linear, of rank ``lora_rank`` and
        #: scale ``lora_alpha / lora_rank``; per-slot adapter ids flow
        #: through ``forward_cached`` / ``forward_paged`` and id -1 is
        #: bitwise the base model.  0 = no LoRA.
        if int(lora_capacity) < 0:
            raise ValueError(
                f"lora_capacity must be >= 0, got {lora_capacity!r}")
        if int(lora_capacity) > 0 and int(lora_rank) < 1:
            raise ValueError(
                f"lora_rank must be >= 1, got {lora_rank!r}")
        self.lora_capacity = int(lora_capacity)
        self.lora_rank = int(lora_rank)
        self.lora_alpha = float(lora_alpha)


def gpt_tiny(**kw):
    cfg = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
               max_position=64, dropout=0.0)
    cfg.update(kw)
    return GPTConfig(**cfg)


def gpt_small(**kw):
    """GPT-2 small: vocab 50304, hidden 768, 12 layers x 12 heads."""
    return GPTConfig(**kw)


def _unported(cfg: GPTConfig):
    if cfg.dtype not in _DTYPES:
        raise UnimplementedError(
            f"GPTConfig.dtype={cfg.dtype!r}: the port runs float32 or "
            f"bfloat16")


def _gather_attend(q, kv, gather_tab, mask):
    """Gather-then-attend over a paged pool — the JAX ``forward_paged``
    path off ``paged_flash_eligible`` (``paddle_tpu/models/gpt.py``):
    each slot's pages gathered into a ``[B, H, G*page, hd]`` view
    (a quantized pool's rows times their scales, cast to q's dtype),
    scores in q's dtype filled with ``finfo.min`` where masked, softmax,
    the product with the view.  A fully masked row gets a uniform softmax
    there, as in the JAX package (ROADMAP §C)."""
    B, H, T, hd = q.shape
    tab = gather_tab.long()
    G, page = tab.shape[1], kv["k"].shape[2]

    def view(name):
        x = kv[name][tab]                                # [B,G,H,page,hd]
        x = x.permute(0, 2, 1, 3, 4).reshape(B, H, G * page, hd)
        scale = kv.get(name + "_scale")
        if scale is not None:
            sc = scale[tab].permute(0, 2, 1, 3).reshape(B, H, G * page)
            x = x.float() * sc[..., None]
        return x.to(q.dtype)

    kview, vview = view("k"), view("v")
    scores = torch.einsum("bhqd,bhcd->bhqc", q, kview) / math.sqrt(hd)
    scores = scores.masked_fill(~mask.bool()[:, None],
                                torch.finfo(scores.dtype).min)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqc,bhcd->bhqd", probs, vview)


def _mesh_degree(axis: str) -> int:
    from ..distributed.mesh import get_mesh

    return get_mesh().shape.get(axis, 1)


class ParallelAttention(nn.Layer):
    """Causal multi-head self-attention; over a ``model`` axis each rank
    holds ``H / mp`` heads.  With ``sequence_parallel`` set
    ("ring"/"ulysses") and a ``sep`` axis of size > 1, attention runs on
    this rank's sequence chunk through ring attention or Ulysses (the
    built-in causal mask only)."""

    def __init__(self, cfg: GPTConfig):
        super().__init__()
        d, h = cfg.hidden_size, cfg.num_heads
        if d % h:
            raise ValueError(f"hidden {d} % heads {h} != 0")
        self.num_heads = h
        self.head_dim = d // h
        self.qkv = ColumnParallelLinear(d, 3 * d, gather_output=False,
                                        partition_groups=3)
        self.out = RowParallelLinear(d, d, input_is_parallel=True)
        self.drop = nn.Dropout(cfg.dropout)
        self.sequence_parallel = cfg.sequence_parallel

    def _heads(self, x):
        """qkv projection → per-head ``[B,H,S,hd]`` triples (this rank's
        heads)."""
        B, S, _ = x.shape
        qkv = self.qkv(x)
        qkv = qkv.reshape(B, S, 3, qkv.shape[-1] // (3 * self.head_dim),
                          self.head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # [B,S,H,hd]
        return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

    def forward(self, x, attn_mask=None):
        """Causal attention: the flash kernel where :meth:`_use_flash`
        admits it (long context on the card), else the dense einsum path
        of the JAX package."""
        B, S, _ = x.shape
        q, k, v = self._heads(x)
        if (self.sequence_parallel and attn_mask is None
                and _mesh_degree("sep") > 1):
            ctx = self._sp_attention(q, k, v)  # [B,H,S,hd]
        elif self._use_flash(S, attn_mask, x):
            # O(S) attention memory: the [B, H, S, S] scores never exist
            ctx = flash_attention(q, k, v, causal=True)
        else:
            scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(
                self.head_dim)
            causal = torch.ones(S, S, dtype=torch.bool,
                                device=x.device).tril()
            scores = scores.masked_fill(~causal,
                                        torch.finfo(scores.dtype).min)
            if attn_mask is not None:
                scores = scores + attn_mask.to(scores.dtype)
            probs = self.drop(torch.softmax(scores, dim=-1))
            ctx = torch.einsum("bhqk,bhkd->bhqd", probs, v)
        return self.out(ctx.transpose(1, 2).reshape(B, S, -1))

    def _use_flash(self, S, attn_mask, x) -> bool:
        """The JAX gate (``paddle_tpu/models/gpt.py`` ``_use_flash``) with
        "the activation is on CUDA" for "the backend is TPU": no extra
        mask, S >= 4096, S % 128 == 0, head_dim in {64, 128, 256}, no
        probs-dropout in effect (p 0 or eval mode), and no ``model`` /
        ``sep`` sharding (JAX's clauses).  Training takes it too: the
        flash backward kernels are the VJP."""
        return (attn_mask is None and S >= 4096 and S % 128 == 0
                and self.head_dim in FLASH_HEAD_DIMS
                and (self.drop.p == 0.0 or not self.training)
                and _mesh_degree("model") == 1
                and _mesh_degree("sep") == 1
                and x.device.type == "cuda")

    def _sp_attention(self, q, k, v):
        """This rank's sequence chunk through ring attention or Ulysses
        over ``sep``; the chunks are joined again (the JAX ``shard_map``
        over ``P(batch, model, "sep", None)``)."""
        from ..distributed.sequence_parallel import (
            ring_attention_sharded,
            ulysses_attention_sharded,
        )

        fn = (ulysses_attention_sharded
              if self.sequence_parallel == "ulysses"
              else ring_attention_sharded)
        return fn(q, k, v, axis="sep", causal=True)

    def forward_cached(self, x, kv, write, mask):
        """One attention step over a ring KV cache (``GPTModel.init_cache``)
        — the default serving engine's prefill / decode step.

        ``write`` is ``(b, t, c)``: the ``[N]`` batch rows, token columns
        and ring slots of the tokens this call writes (``positions % C``,
        padding ``-1`` left out; resolved on the host by
        :meth:`GPTModel.forward_cached`).  Their K/V are written into the
        ``[B,H,C,hd]`` buffers of ``kv`` in place (JAX scatters a one-hot
        ``hit`` through an einsum; with 1.0 the product is exact, so the
        ring holds the same values), then attention runs over the WHOLE
        ring under ``mask`` ``[B,T,C]``: scores filled with ``finfo.min``
        where masked, softmax, the product with V — the JAX einsums.  A
        row that sees no key (a free slot) gets a uniform softmax, as in
        JAX.  Returns ``(out, kv)``."""
        B, T, D = x.shape
        q, k, v = self._heads(x)  # [B,H,T,hd]
        b, t, c = write
        if b.numel():
            kv["k"][b, :, c] = k[b, :, t].to(kv["k"].dtype)
            kv["v"][b, :, c] = v[b, :, t].to(kv["v"].dtype)
        scores = torch.einsum("bhqd,bhcd->bhqc", q, kv["k"]) / math.sqrt(
            self.head_dim)
        scores = scores.masked_fill(~mask[:, None],
                                    torch.finfo(scores.dtype).min)
        probs = torch.softmax(scores, dim=-1)
        ctx = torch.einsum("bhqc,bhcd->bhqd", probs, kv["v"])
        return self.out(ctx.transpose(1, 2).reshape(B, T, D)), kv

    def forward_paged(self, x, kv, write_page, write_off, gather_tab, mask):
        """One attention step over a PAGED KV pool.

        The new tokens' K/V are scattered in place into the shared pool at
        the host-resolved physical coordinates (``write_page`` /
        ``write_off``, flattened ``[B*T]``; padding lands in the last,
        write-drop page), then :func:`paged_flash_decode` walks each slot's
        page-table row (``gather_tab`` ``[B,G]``, pre-clipped) under
        ``mask`` ``[B,T,C]`` — where ``paged_flash_eligible`` admits the
        head_dim and page size, as in the JAX package; off it the
        gather-then-attend path (:func:`_gather_attend`) runs instead.  A
        quantized pool (``k_scale`` in ``kv``) quantizes on write — one
        scale per written token per head into the scale planes — and the
        kernel dequantizes per page; the write-drop page's scales are
        never read unmasked.  Returns ``(out, kv)``."""
        B, T, D = x.shape
        H, hd = self.num_heads, self.head_dim
        q, k, v = self._heads(x)  # [B,H,T,hd]
        kw = k.transpose(1, 2).reshape(B * T, H, hd)
        vw = v.transpose(1, 2).reshape(B * T, H, hd)
        if "k_scale" in kv:
            kw, ks = _quantize_kv(kw, kv["k"].dtype)
            vw, vs = _quantize_kv(vw, kv["v"].dtype)
            kv["k_scale"][write_page, :, write_off] = ks
            kv["v_scale"][write_page, :, write_off] = vs
        kv["k"][write_page, :, write_off] = kw.to(kv["k"].dtype)
        kv["v"][write_page, :, write_off] = vw.to(kv["v"].dtype)
        if paged_flash_eligible(hd, kv["k"].shape[2]):
            ctx = paged_flash_decode(q.contiguous(), kv["k"], kv["v"],
                                     gather_tab, mask, kv.get("k_scale"),
                                     kv.get("v_scale"))  # [B,H,T,hd]
        else:
            ctx = _gather_attend(q, kv, gather_tab, mask)
        return self.out(ctx.transpose(1, 2).reshape(B, T, D)), kv


class ParallelMLP(nn.Layer):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.fc1 = ColumnParallelLinear(cfg.hidden_size,
                                        cfg.intermediate_size,
                                        gather_output=False)
        self.fc2 = RowParallelLinear(cfg.intermediate_size, cfg.hidden_size,
                                     input_is_parallel=True)
        self.act = nn.GELU()
        self.drop = nn.Dropout(cfg.dropout)

    def forward(self, x):
        return self.drop(self.fc2(self.act(self.fc1(x))))


class GPTBlock(nn.Layer):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.ln1 = nn.LayerNorm(cfg.hidden_size,
                                epsilon=cfg.layer_norm_epsilon)
        self.attn = ParallelAttention(cfg)
        self.ln2 = nn.LayerNorm(cfg.hidden_size,
                                epsilon=cfg.layer_norm_epsilon)
        if cfg.moe_experts:
            self.mlp = MoELayer(cfg)
        else:
            self.mlp = ParallelMLP(cfg)

    def forward(self, x, attn_mask=None):
        # the fused form of the JAX block (models/gpt.py GPTBlock.forward):
        # the attention residual add and ln2 are one layernorm_residual
        # call, which returns the residual stream s and the MLP input h
        a = self.attn(self.ln1(x), attn_mask)
        s, h = layernorm_residual(a, x, self.ln2.weight, self.ln2.bias,
                                  epsilon=self.ln2.epsilon)
        return s + self.mlp(h)

    def forward_cached(self, x, kv, write, mask):
        # unfused, as the JAX serving path is (gpt.py GPTBlock.forward_cached)
        a, kv = self.attn.forward_cached(self.ln1(x), kv, write, mask)
        x = x + a
        return x + self.mlp(self.ln2(x)), kv

    def forward_paged(self, x, kv, write_page, write_off, gather_tab, mask):
        # unfused, as the JAX serving path is
        a, kv = self.attn.forward_paged(self.ln1(x), kv, write_page,
                                        write_off, gather_tab, mask)
        x = x + a
        return x + self.mlp(self.ln2(x)), kv


class GPTModel(nn.Layer):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        _unported(cfg)
        self.cfg = cfg
        self.wte = VocabParallelEmbedding(cfg.vocab_size, cfg.hidden_size)
        self.wpe = nn.Embedding(cfg.max_position, cfg.hidden_size,
                                std=0.02)
        self.drop = nn.Dropout(cfg.dropout)
        self.blocks = torch.nn.ModuleList(
            [GPTBlock(cfg) for _ in range(cfg.num_layers)])
        self.ln_f = nn.LayerNorm(cfg.hidden_size,
                                 epsilon=cfg.layer_norm_epsilon)
        if cfg.lora_capacity > 0:
            # zero-initialized adapter tables on every block projection
            # (an MoE block's experts are not parallel linears: qkv / out
            # only); zero tables + id -1 keep the model bitwise the base
            from ..lora.batched import enable_lora

            enable_lora(self, cfg.lora_capacity, cfg.lora_rank,
                        cfg.lora_alpha, dtype=cfg.dtype)

    def _lora_scope(self, adapter_ids):
        """Scope the ``[B]`` per-slot adapter ids around the block stack
        (a ``nullcontext`` when the caller passed none), uploaded to the
        model's device once; the block projections pick them up through
        ``lora.runtime``.  The embeddings, the final LN and the tied LM
        head are outside the scope and never adapted."""
        if adapter_ids is None:
            return contextlib.nullcontext()
        from ..lora.runtime import adapter_scope

        if not isinstance(adapter_ids, torch.Tensor):
            adapter_ids = upload(np.asarray(adapter_ids, np.int32),
                                 self.wte.weight.device)
        return adapter_scope(adapter_ids)

    def forward(self, input_ids, attn_mask=None):
        S = input_ids.shape[1]
        pos = torch.arange(S, device=input_ids.device)[None, :]
        x = self.drop(self.wte(input_ids) + self.wpe(pos))
        for blk in self.blocks:
            x = blk(x, attn_mask)
        return self.ln_f(x)

    # -- ring KV cache (the default serving engine) ----------------------
    def init_cache(self, batch_size: int, cache_len: Optional[int] = None,
                   dtype=None):
        """Preallocate a ring KV cache on the model's device: per-layer
        ``[B,H,C,hd]`` K/V buffers in the model's float dtype (a quantized
        model's ring stays float, as in JAX) and one shared ``[B,C]`` int32
        slot→absolute-position map (``-1`` = empty).  While a row's
        position stays below ``C`` attention is exact; past it the ring
        overwrites the oldest entries (sliding-window decode)."""
        cfg = self.cfg
        C = int(cache_len or cfg.max_position)
        dt = _DTYPES.get(str(dtype or cfg.dtype).replace("torch.", ""))
        if dt is None:
            raise InvalidArgumentError(
                f"init_cache(dtype={dtype!r}): the ring is float32 or "
                f"bfloat16")
        hd = cfg.hidden_size // cfg.num_heads
        dev = self.wte.weight.device
        shape = (int(batch_size), cfg.num_heads, C, hd)
        return {
            "pos": torch.full((int(batch_size), C), -1, dtype=torch.int32,
                              device=dev),
            "layers": [{"k": torch.zeros(shape, dtype=dt, device=dev),
                        "v": torch.zeros(shape, dtype=dt, device=dev)}
                       for _ in range(cfg.num_layers)],
        }

    @staticmethod
    def reset_slots(cache, slot_mask):
        """Evict batch slots, in place: the position-map rows of masked
        slots become ``-1`` (nothing attends to them); K/V payloads stay,
        as in JAX — visibility is decided by ``pos`` alone.  Unmasked rows
        are not touched.  ``slot_mask``: ``[B]`` bool (host or device).
        Returns ``cache``."""
        pos = cache["pos"]
        m = slot_mask if isinstance(slot_mask, torch.Tensor) else upload(
            np.asarray(slot_mask, bool).reshape(-1), pos.device)
        pos.masked_fill_(m.to(pos.device, torch.bool)[:, None], -1)
        return cache

    @staticmethod
    def write_slots(cache, src, slot_mask):
        """Copy whole cache rows of ``src`` (a cache of the same shapes)
        into ``cache`` where ``slot_mask`` (``[B]`` bool) is set, in place —
        JAX's admission merge.  Only the masked rows are written; the
        others stay bit-identical.  Returns ``cache``."""
        m = _host_bool(slot_mask)
        if m.shape != (cache["pos"].shape[0],) or (
                src["pos"].shape != cache["pos"].shape):
            raise InvalidArgumentError(
                f"write_slots: a {m.shape[0]}-entry mask and a "
                f"{tuple(src['pos'].shape)} source for a "
                f"{tuple(cache['pos'].shape)} cache")
        rows = np.nonzero(m)[0]
        if not len(rows):
            return cache
        r = upload(rows.astype(np.int64), cache["pos"].device)
        cache["pos"].index_copy_(0, r, src["pos"].index_select(0, r))
        for d, s_ in zip(cache["layers"], src["layers"]):
            for key in ("k", "v"):
                d[key].index_copy_(0, r, s_[key].index_select(0, r))
        return cache

    def forward_cached(self, input_ids, positions, cache, adapter_ids=None):
        """Prefill/decode forward over :meth:`init_cache` state.

        ``input_ids`` / ``positions`` are ``[B,T]``: ``T`` is the prompt
        bucket for a prefill, 1 for a decode step; positions are ABSOLUTE
        per sequence, ``-1`` = padding (writes nothing, attends to
        nothing).  ``positions`` is read on the host (pass numpy, as the
        engines do, to keep the card's queue running; a card tensor costs
        a sync): the ring slots each token writes are resolved there and
        go to the card in one copy with the positions.  A call writes at
        most ``C`` tokens a row.  The ring is updated in place.
        ``adapter_ids`` ``[B]`` (``-1`` = none) selects each row's LoRA
        table slot for the block stack.  Returns ``(hidden [B,T,D],
        cache)``."""
        pos = _host_ints(positions)
        B, T = pos.shape
        C = cache["pos"].shape[1]
        if T > C:
            raise InvalidArgumentError(
                f"forward_cached: {T} tokens a row exceed the ring's {C} "
                f"slots")
        b, t = np.nonzero(pos >= 0)
        dev = cache["pos"].device
        packed = upload(np.concatenate(
            [pos.reshape(-1), b, t, pos[b, t] % C]).astype(np.int64), dev)
        qp = packed[:B * T].view(B, T)
        write = packed[B * T:].view(3, -1).unbind(0)
        if not isinstance(input_ids, torch.Tensor):
            input_ids = upload(np.asarray(input_ids, np.int64), dev)
        x = self.drop(self.wte(input_ids) + self.wpe(qp.clamp_min(0)))
        if len(b):
            cache["pos"][write[0], write[2]] = qp[write[0], write[1]].to(
                torch.int32)
        # a key is visible iff its slot holds a real token, causally
        # before (or at) the query, and not yet overwritten by the ring
        kp, q = cache["pos"][:, None, :], qp[:, :, None]
        mask = (kp >= 0) & (kp <= q) & (kp > q - C)  # [B,T,C]
        with self._lora_scope(adapter_ids):
            for blk, kv in zip(self.blocks, cache["layers"]):
                x, _ = blk.forward_cached(x, kv, write, mask)
        return self.ln_f(x), cache

    # -- paged KV cache (vLLM-style PagedAttention; Kwon et al. 2023) -------
    def init_paged_cache(self, num_pages: int, page_size: int, dtype=None):
        """Preallocate a paged KV pool: per-layer ``[P+1, H, page, hd]``
        K/V page tensors shared by ALL slots, on the model's device.  Which
        physical page holds which slot's tokens is decided per call by a
        host-owned page table (:meth:`forward_paged`).  Index ``P`` (the
        last page) is the write-DROP page: padding tokens scatter there
        and no valid mask entry ever reads it.

        ``dtype=torch.int8`` (or ``torch.float8_e4m3fn``) switches the
        pool to QUANTIZED KV pages: each layer additionally holds
        ``k_scale`` / ``v_scale`` ``[P+1, H, page]`` float32 planes (one
        scale per written token per head); K/V quantize on write in
        :meth:`forward_paged` and dequantize inside the attention kernel.
        The host-side page table and copy-on-write machinery is
        dtype-blind."""
        cfg = self.cfg
        dt = _POOL_DTYPES.get(str(dtype or cfg.dtype).replace("torch.", ""))
        if dt is None:
            raise InvalidArgumentError(
                f"init_paged_cache(dtype={dtype!r}): the pool is float32, "
                f"bfloat16, int8 or float8_e4m3fn")
        hd = cfg.hidden_size // cfg.num_heads
        shape = (int(num_pages) + 1, cfg.num_heads, int(page_size), hd)
        dev = self.wte.weight.device

        def layer():
            l = {"k": torch.zeros(shape, dtype=dt, device=dev),
                 "v": torch.zeros(shape, dtype=dt, device=dev)}
            if dt in _QUANT_POOL_DTYPES:
                l["k_scale"] = torch.zeros(shape[:3], dtype=torch.float32,
                                           device=dev)
                l["v_scale"] = torch.zeros(shape[:3], dtype=torch.float32,
                                           device=dev)
            return l

        return {"layers": [layer() for _ in range(cfg.num_layers)]}

    def copy_pages(self, cache, src, dst):
        """Copy whole pages ``src[i] → dst[i]`` inside the pool, in place —
        the copy-on-write op.  ``-1`` entries are no-ops (the copy lands in
        the write-drop page).  Every per-layer tensor is page-major, so a
        quantized pool's ``k_scale`` / ``v_scale`` planes move with their
        pages.  Returns ``cache``."""
        P = cache["layers"][0]["k"].shape[0] - 1
        dev = cache["layers"][0]["k"].device
        src = torch.as_tensor(src, dtype=torch.long, device=dev).clamp_min(0)
        dst = torch.as_tensor(dst, dtype=torch.long, device=dev)
        dst = torch.where(dst >= 0, dst, torch.full_like(dst, P))
        for layer in cache["layers"]:
            for t in layer.values():
                t[dst] = t[src]
        return cache

    @staticmethod
    def gather_pages(cache, idx):
        """Read whole pages out of the pool — the export half of the
        prefill→decode KV hand-off.  ``idx``: ``[K]`` physical page
        numbers (``-1`` reads the write-drop page P).  Returns ONE host
        array ``[L, 2, K, H, page, hd]`` (layer-major, k / v interleaved),
        a single copy off the card.

        Quantized pools return ``(pages, scales)``: the quantized stack
        plus its ``[L, 2, K, H, page]`` float32 scale stack, so a hand-off
        never round-trips through float.  numpy has no float8: an fp8
        pool's pages travel as their raw bits in ``uint8`` (and a bf16
        pool's in ``int16``); :meth:`scatter_pages` reinterprets them, so
        the adopting pool holds the donor's bits exactly."""
        layers = cache["layers"]
        P = layers[0]["k"].shape[0] - 1
        i = _host_ints(idx).reshape(-1)
        i = upload(np.where(i >= 0, i, P), layers[0]["k"].device)
        dt = layers[0]["k"].dtype
        raw = RAW_BITS.get(dt, (dt,))[0]  # fp8 / bf16 moved as raw bits
        pages = torch.stack([torch.stack([l["k"].view(raw)[i],
                                          l["v"].view(raw)[i]])
                             for l in layers]).cpu().numpy()
        if "k_scale" not in layers[0]:
            return pages
        scales = torch.stack([torch.stack([l["k_scale"][i],
                                           l["v_scale"][i]])
                              for l in layers])
        return pages, scales.cpu().numpy()

    @staticmethod
    def scatter_pages(cache, kv, dst):
        """Write a :meth:`gather_pages` payload into the pool, in place —
        the import half of the hand-off.  ``dst``: the ``[K]`` target
        pages the adopting host allocated (distinct); ``-1`` entries land
        in the write-drop page P.  Several ``-1`` entries write P in the
        JAX package's order, the last one kept (on CUDA an indexed copy
        with repeated targets has no defined order, so P is written once,
        from the last such entry).  A quantized pool takes the ``(pages,
        scales)`` pair.  Returns ``cache``."""
        scales = None
        if isinstance(kv, (tuple, list)):
            kv, scales = kv
        layers = cache["layers"]
        if "k_scale" in layers[0] and scales is None:
            raise InvalidArgumentError(
                "scatter_pages: quantized pool needs the (pages, scales) "
                "pair gather_pages exported")
        P = layers[0]["k"].shape[0] - 1
        d = _host_ints(dst).reshape(-1)
        keep = np.nonzero(d >= 0)[0]
        drop = np.nonzero(d < 0)[0][-1:]  # the last -1 entry wins
        src = np.concatenate([keep, drop])
        to = np.concatenate([d[keep], np.full(len(drop), P, np.int64)])
        if not len(src):
            return cache
        dev = layers[0]["k"].device
        src_d, to_d = upload(src, dev), upload(to, dev)
        dt = layers[0]["k"].dtype
        raw = RAW_BITS.get(dt, (dt,))[0]  # index_copy_ has no float8
        pages = _from_host(kv, dt, dev).view(raw)
        sc = (None if scales is None or "k_scale" not in layers[0]
              else _from_host(scales, torch.float32, dev))
        for i, l in enumerate(layers):
            for j, key in enumerate(("k", "v")):
                l[key].view(raw).index_copy_(
                    0, to_d, pages[i, j].index_select(0, src_d))
                if sc is not None:
                    l[key + "_scale"].index_copy_(
                        0, to_d, sc[i, j].index_select(0, src_d))
        return cache

    def forward_paged(self, input_ids, positions, pos_map, table, cache,
                      adapter_ids=None):
        """Prefill/decode forward over :meth:`init_paged_cache` state.

        ``input_ids`` / ``positions`` are ``[B,T]`` with absolute positions
        and ``-1`` = padding; ``table`` ``[B,G]`` maps each slot's logical
        pages to physical pool pages (``-1`` = unmapped); ``pos_map``
        ``[B,C]`` (``C = G*page``) is the slot→absolute-position map
        *after this call's writes*.  ``adapter_ids`` ``[B]`` (``-1`` =
        none) selects each row's LoRA table slot for the block stack.
        Returns ``(hidden [B,T,D], cache)`` with the pool updated in place.
        """
        positions = positions.long()
        pos_map = pos_map.long()
        table = table.int()
        P = cache["layers"][0]["k"].shape[0] - 1
        page = cache["layers"][0]["k"].shape[2]
        G = table.shape[1]
        C = G * page
        x = self.drop(self.wte(input_ids) + self.wpe(positions.clamp_min(0)))
        slots = torch.where(positions >= 0, positions % C,
                            torch.full_like(positions, -1))
        g = torch.div(slots, page, rounding_mode="floor").clamp(0, G - 1)
        off = torch.remainder(slots, page).clamp(0, page - 1)
        phys = torch.take_along_dim(table.long(), g, dim=1)  # [B,T]
        # padding tokens and unmapped pages write into the drop page P
        phys = torch.where((slots >= 0) & (phys >= 0), phys,
                           torch.full_like(phys, P))
        write_page, write_off = phys.reshape(-1), off.reshape(-1)
        kp, qp = pos_map[:, None, :], positions[:, :, None]
        mask = (kp >= 0) & (kp <= qp) & (kp > qp - C)  # [B,T,C]
        gather_tab = table.clamp_min(0).contiguous()  # unmapped → page 0
        with self._lora_scope(adapter_ids):
            for blk, kv in zip(self.blocks, cache["layers"]):
                x, _ = blk.forward_paged(x, kv, write_page, write_off,
                                         gather_tab, mask)
        return self.ln_f(x), cache


class GPTForCausalLM(nn.Layer):
    """LM head ties the input embedding: ``logits = h @ wte.weight.T``.

    ``device`` — ``None`` runs on the CUDA card (raises
    ``UnavailableError`` when there is none), ``"cpu"`` on the CPU.
    ``generator`` — the ``torch.Generator`` the weights are drawn from
    (default: the one :func:`paddle_tpu_torch.seed` reseeds); weights are
    drawn on the CPU and moved, so a seed gives the same model on any
    device.
    """

    @fills_its_layers
    def __init__(self, cfg: GPTConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.gpt = GPTModel(cfg)
        self._moe_aux = None
        gen = generator if generator is not None else default_generator()
        for m in self.modules():
            if hasattr(m, "reset_parameters"):
                m.reset_parameters(gen)
        # the adapter scales stay float32 in every model dtype, as JAX's
        scales = {n: b for n, b in self.named_buffers()
                  if n.endswith(".lora_scale")}
        self.to(device=dev, dtype=_DTYPES[cfg.dtype])
        for n, b in scales.items():
            owner, _, leaf = n.rpartition(".")
            self.get_submodule(owner)._buffers[leaf] = b.to(dev)
        if cfg.quantization != "none":
            # lazy import: slim imports the layers this module builds on
            from ..slim.quantization import quantize_weights

            quantize_weights(self, cfg.quantization)

    @property
    def device(self) -> torch.device:
        return self.gpt.wte.weight.device

    def _logits(self, h):
        # jnp.einsum promotes: under amp O2 the table is bf16 beside ln_f's
        # float32 output
        wte = self.gpt.wte
        parts = wte.num_embeddings // wte.weight.shape[0]
        if parts == 1:
            return torch.matmul(*promote(h, wte.weight.t()))
        # a vocabulary-sharded table: this rank's logit columns, gathered
        # to the whole vocabulary (the JAX constrain to replicated)
        from ..distributed.meta_parallel import (_model_group, copy_to,
                                                 gather_from)

        g = _model_group(parts, wte)
        local = torch.matmul(*promote(copy_to(h, g), wte.weight.t()))
        return gather_from(local, g, -1)

    def forward(self, input_ids, attn_mask=None):
        # the MoE blocks' load-balance losses (None for a dense model);
        # loss() consumes the stash (Model.train_batch calls forward, then
        # loss)
        with moe_stats.collect() as ms:
            h = self.gpt(input_ids, attn_mask)  # [B,S,D]
        self._moe_aux = ms.total_aux()
        return self._logits(h)  # [B,S,V]

    def loss(self, logits, labels):
        """Shifted next-token cross entropy (labels = input_ids): the mean
        of :func:`softmax_cross_entropy` over the ``B·(S-1)`` rows, plus
        ``moe_balance_weight ×`` the summed load-balance loss the MoE
        blocks recorded in the last :meth:`forward` (consumed here).  The
        shifted ``[B, S-1, V]`` view is copied to contiguous rows first,
        as XLA does."""
        logits = logits[:, :-1]
        labels = torch.as_tensor(labels, device=logits.device)[:, 1:]
        V = logits.shape[-1]
        out = softmax_cross_entropy(logits.reshape(-1, V),
                                    labels.reshape(-1)).mean()
        aux, self._moe_aux = self._moe_aux, None  # consume: never leak
        if aux is not None:  # the loss is float32, so is the weight
            out = out + float(self.gpt.cfg.moe_balance_weight) * aux
        return out

    def forward_cached(self, input_ids, positions, cache, gather_last=None,
                       adapter_ids=None):
        """Ring KV forward (see :meth:`GPTModel.forward_cached`).  With
        ``gather_last`` (per-sequence prompt lengths ``[B]``) only the
        hidden state at ``length-1`` is projected: logits ``[B,V]``
        instead of ``[B,T,V]``."""
        h, cache = self.gpt.forward_cached(input_ids, positions, cache,
                                           adapter_ids=adapter_ids)
        if gather_last is not None:
            idx = (upload(_host_ints(gather_last).reshape(-1), h.device)
                   - 1).clamp_min(0)
            h = h[torch.arange(h.shape[0], device=h.device), idx]  # [B,D]
        return self._logits(h), cache

    def forward_paged(self, input_ids, positions, pos_map, table, cache,
                      gather_last=None, adapter_ids=None):
        """Paged KV forward (see :meth:`GPTModel.forward_paged`).  With
        ``gather_last`` (per-sequence prompt lengths ``[B]``) only the
        hidden state at ``length-1`` is projected: logits ``[B,V]``
        instead of ``[B,T,V]``."""
        h, cache = self.gpt.forward_paged(input_ids, positions, pos_map,
                                          table, cache,
                                          adapter_ids=adapter_ids)
        if gather_last is not None:
            idx = (gather_last.long() - 1).clamp_min(0)
            h = h[torch.arange(h.shape[0], device=h.device), idx]  # [B,D]
        return self._logits(h), cache
