"""Batched greedy generation for ``models.GPTForCausalLM`` (port of
``paddle_tpu.serving.generation.GenerationEngine``).

Three schedulers, chosen as in the JAX package by ``continuous`` /
``paged`` (defaults ``FLAGS_continuous_batching`` = True,
``FLAGS_paged_kv`` = False):

**Dense-ring continuous batching** (the default): a persistent decode loop
owns the ``B``-slot batch and ONE ring KV cache (``GPTModel.init_cache``,
``[B,H,C,hd]`` per layer, allocated once).  Each iteration admits queued
requests FCFS into free slots — the admitted rows are cleared (positions
``-1``, K/V zeros: what JAX merges in from the fresh cache it prefills)
and the group is prefilled straight into their ring rows, padded to its
largest prompt bucket, every other row at position ``-1`` (writes
nothing, so live rows stay bit-identical) —
dispatches the next ``[B, 1]`` decode step, then harvests the OLDER
in-flight step: its tokens come back through a pinned non-blocking copy
and a CUDA event, so one step is always queued on the card while the host
books the previous one.  Per-slot generation counters discard the (at
most one) token a finished slot's in-flight step still produces.
Because every row's computation depends only on its own row, tokens equal
the legacy scheduler's and uncached greedy.

**Legacy run-batch-to-completion** (``continuous=False``): the
worker-mode ``MicroBatcher`` groups same-bucket requests (up to
``batch_size``, waiting at most ``max_queue_delay_ms``), and each batch is
prefilled into the ring (cleared first) and decoded until its
last request ends — head-of-line blocking included.  The batch runs under
the circuit breaker and ``RetryPolicy.from_flags``.

**Paged KV** (``paged=True``): one shared page pool
(``GPTModel.init_paged_cache``) behind a host-owned slot→page-table
indirection (``serving/paging.py``) — vLLM-style PagedAttention, with
copy-on-write prefix sharing, n-gram speculative verify steps and
preemption of the newest slot when the pool runs dry.  Every admission
and every step runs ``num_layers`` launches of the ``paged_flash_decode``
CUDA kernel on the card.  ``role="prefill"`` / ``"decode"`` split it in
two (prefill/decode disaggregation): a prefill engine answers
``submit(..., handoff=True)`` with a :class:`KVHandoff` (the prompt's
pages as one host array, plus the first token) and a decode engine
adopts one (``PagePool.adopt`` + ``GPTModel.scatter_pages``) and decodes
on, token-identical to a co-located engine.

``quantized="int8" | "fp8"`` serves from a quantized copy of the model
(``slim.quantize_model``; the caller's model keeps its float weights):
four ``quantized_matmul`` kernel launches per layer per call; a paged
engine stores int8 / float8_e4m3fn KV pages with float32 scale planes,
the dense ring stays float (``cfg.dtype``), as in JAX.  A mixture-of-
experts model serves in every mode, its expert FFNs through
``grouped_matmul`` (float experts beside quantized attention in a
quantized engine, as in JAX), and reports its routing health
(``MOE_COUNTERS``): every decode / verify step's ``[2, E]`` routed /
dropped counts, from the step's inert rows too.  Steps run while warming
up are not counted, in every mode (the JAX tap folds the token totals of
all warm-up calls but the last); the dense loops bring a step's counts
back with its tokens, in one pinned copy and one event.

:meth:`GenerationEngine.swap_weights` hot-swaps a ``.pdiparams`` side-file
(e.g. a ``slim.export_quantized`` artifact) into the served tensors IN
PLACE, between device calls; :meth:`~GenerationEngine.reload_weights`
re-reads (and, quantized, re-quantizes) the caller's model.  Every
engine serves its own copy of the model's tensors (as the JAX engine
binds its own snapshot), so a swap reaches only the engine it is made
on: the caller's model and other engines over it are untouched.

A model with LoRA tables (``GPTConfig.lora_capacity > 0``) serves many
adapters from one engine in every mode: each request carries an adapter
slot (``submit(..., adapter_id=)``, ``-1`` = the base model, bitwise), the
loops keep a per-slot id column and pass it on every call
(``forward_cached`` / ``forward_paged``'s ``adapter_ids``), so each adapted
linear runs two ``grouped_matmul`` launches a call even when every row is
``-1``.  :meth:`~GenerationEngine.install_adapter` /
:meth:`~GenerationEngine.remove_adapter` write a table slot of the
engine's own copy in place, between device calls.  ``tenancy=`` (a
:class:`~.tenancy.TenantScheduler`, paged only) orders admission
weighted-fair over tenants, defers over-budget tenants' requests and
preempts their live slots through the paged preemption path; requests
tagged ``submit(..., tenant=)`` take the tenant's adapter slot by default.

Engines follow the model's device: a model built on the card (the
default) serves there, a ``device="cpu"`` model through the kernels'
plain versions.  Not ported yet (ROADMAP queue A): tracing spans and
the event-bus snapshots (the tenancy snapshot among them),
``from_tuned``, and a CUDA-graph decode step.
"""
from __future__ import annotations

import copy
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..framework.device import upload
from ..framework.dtype import RAW_BITS
from ..framework.errors import (
    ExecutionTimeoutError,
    InvalidArgumentError,
    UnavailableError,
    is_transient,
)
from ..framework.flags import flag
from ..resilience import CircuitBreaker, RetryPolicy, mark_warm
from ..resilience.faults import fault_point
from ..moe import stats as moe_stats
from .batcher import MicroBatcher, Request
from .metrics import (HANDOFF_COUNTERS, LORA_COUNTERS, MOE_COUNTERS,
                      PAGED_COUNTERS, SLOT_COUNTERS, TENANCY_COUNTERS,
                      ServingMetrics)
from .paging import PagePool

__all__ = ["GenerationEngine", "KVHandoff"]

_gen_counter = [0]


class KVHandoff(NamedTuple):
    """The prefill→decode hand-off payload (disaggregated serving).

    A ``role="prefill"`` engine resolves a ``submit(..., handoff=True)``
    future with one of these instead of a token array: the prompt's KV
    pages exported as ONE host array (``GPTModel.gather_pages``) plus the
    first generated token.  A ``role="decode"`` engine accepts it via
    ``submit(prompt, ..., handoff=<KVHandoff>)``, adopts the pages into
    its own pool and resumes at position ``length`` exactly as if it had
    prefilled locally.  ``done`` short-circuits the decode leg (budget of
    1, or EOS on the first token)."""

    prompt: np.ndarray    # [length] int32 prompt tokens
    first_token: int      # greedy token from the prompt's last logit
    kv: object            # [layers, 2, K, heads, page, hd] host array, or
    #                       a (pages, scales) pair from a quantized pool
    #                       (fp8 pages as their uint8 bits); both engines
    #                       must share the same `quantized` mode
    length: int           # resident KV covers positions 0..length-1
    done: bool            # True: no decode needed (budget 1 / EOS)


class _Readback:
    """A step's ``[B]`` token tensor (and an MoE step's ``[2, E]`` routing
    counts) on its way to the host.  On the card: non-blocking copies into
    pinned memory and a CUDA event recorded after them, so the host can
    queue the next step before this one ends and wait only when it needs
    the tokens.  On the CPU: copies."""

    __slots__ = ("host", "counts", "event")

    def __init__(self, tok: torch.Tensor,
                 counts: Optional[torch.Tensor] = None):
        self.event = None
        if tok.is_cuda:
            self.host, self.counts = (
                None if t is None else
                torch.empty(t.shape, dtype=t.dtype,
                            pin_memory=True).copy_(t, non_blocking=True)
                for t in (tok, counts))
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = tok.clone()
            self.counts = None if counts is None else counts.clone()

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


def _swap_tensor(name: str, a, served: torch.Tensor) -> torch.Tensor:
    """Side-file array ``a`` as a tensor of ``served``'s dtype and shape,
    or ``InvalidArgumentError``.  Accepted: the same dtype (an
    ``ml_dtypes`` bfloat16 / float8 array, as the JAX package writes,
    bit for bit), or float32 for a bf16 / fp8 tensor when every value
    converts exactly (the port's ``save`` widens those dtypes)."""
    a = np.asarray(a)
    if tuple(a.shape) != tuple(served.shape):
        raise InvalidArgumentError(
            f"swap_weights: {name} has shape {tuple(a.shape)}, the served "
            f"model {tuple(served.shape)}")
    raw = RAW_BITS.get(served.dtype)
    if raw is not None and a.dtype.name == str(served.dtype).replace(
            "torch.", ""):
        # an ml_dtypes array (bfloat16, float8_e4m3fn), as JAX writes it
        return torch.from_numpy(np.ascontiguousarray(a).view(raw[1])).view(
            served.dtype)
    t = torch.from_numpy(np.ascontiguousarray(a))
    if t.dtype == served.dtype:
        return t
    if raw is not None and t.dtype == torch.float32:
        c = t.to(served.dtype)
        if torch.equal(c.float(), t):
            return c
    raise InvalidArgumentError(
        f"swap_weights: {name} is {a.dtype}, the served model holds "
        f"{served.dtype}")


class GenerationEngine:
    """Dynamic-batching greedy decoder over a ``GPTForCausalLM``.

    ``prompt_buckets`` — prompt lengths requests are padded up to;
    ``batch_size`` — the decode batch width (free slots run as inert
    ``-1``-position rows); ``cache_len`` — per-slot KV capacity (default
    ``cfg.max_position``; generation past it slides the window);
    ``max_queue_delay_ms`` — the legacy scheduler's batching delay (the
    continuous loops admit at once and only store it).  ``continuous`` /
    ``paged`` default to ``FLAGS_continuous_batching`` /
    ``FLAGS_paged_kv``; ``paged`` needs ``continuous``.  Paged only:
    ``kv_pages`` sizes the shared pool (default ``batch_size * cache_len
    / kv_page_size``), ``kv_page_size`` / ``speculative_k`` default to
    ``FLAGS_kv_page_size`` / ``FLAGS_speculative_k``, and ``role`` is
    ``"any"`` (co-located), ``"prefill"`` or ``"decode"`` (see
    :class:`KVHandoff`).  ``quantized`` — ``None``, ``"int8"`` or
    ``"fp8"`` (see the module docstring); ``model`` itself is left
    untouched.  ``tenancy`` — a :class:`~.tenancy.TenantScheduler`
    (paged only).
    """

    def __init__(self, model, *, prompt_buckets: Sequence[int],
                 batch_size: int = 4, cache_len: Optional[int] = None,
                 max_queue_delay_ms: float = 5.0, max_queue_depth: int = 256,
                 eos_token_id: Optional[int] = None,
                 circuit_breaker: bool = True,
                 retry_transient: bool = True,
                 continuous: Optional[bool] = None,
                 paged: Optional[bool] = None,
                 kv_pages: Optional[int] = None,
                 kv_page_size: Optional[int] = None,
                 speculative_k: Optional[int] = None,
                 role: str = "any",
                 quantized: Optional[str] = None,
                 tenancy=None,
                 name: Optional[str] = None):
        self._continuous = bool(flag("continuous_batching")
                                if continuous is None else continuous)
        self._paged = bool(flag("paged_kv") if paged is None else paged)
        if self._paged and not self._continuous:
            raise InvalidArgumentError(
                "paged_kv requires continuous batching (the legacy "
                "run-batch path owns no persistent device state to page)")
        if role not in ("any", "prefill", "decode"):
            raise InvalidArgumentError(
                f"role must be 'any', 'prefill' or 'decode', got {role!r}")
        if role != "any" and not self._paged:
            raise InvalidArgumentError(
                f"role={role!r} requires paged KV (the hand-off moves "
                f"pages, not dense ring regions)")
        self._role = role
        if quantized is not None and quantized not in ("int8", "fp8"):
            raise InvalidArgumentError(
                f"quantized must be None, 'int8' or 'fp8', got "
                f"{quantized!r}")
        cfg = model.gpt.cfg
        self._moe_experts = int(cfg.moe_experts or 0)
        # per-expert routed totals since warm-up (the dead-expert gauge)
        self._moe_routed_cum = np.zeros(max(self._moe_experts, 1), np.int64)
        # batched multi-LoRA: capacity > 0 threads a per-slot adapter-id
        # column through every device call (warm-up runs it at all -1)
        self._lora_cap = int(cfg.lora_capacity or 0)
        self._adapters: Dict[int, str] = {}       # slot -> adapter name
        self._adapter_hits = np.zeros(max(self._lora_cap, 1), np.int64)
        self._tenancy = tenancy
        if tenancy is not None and not self._paged:
            raise InvalidArgumentError(
                "tenancy requires paged KV (budget preemption rides the "
                "deterministic paged-pool release path)")
        if name is None:
            _gen_counter[0] += 1
            name = f"generate#{_gen_counter[0]}"
        self.name = name
        model.eval()
        self._source = model  # what reload_weights re-reads
        self._quantized = quantized
        # the engine serves its own copy (JAX binds a snapshot): a swap
        # writes into this engine alone, never into the caller's model or
        # another engine's step; quantized, the copy is quantized once here
        if quantized is not None:
            from ..slim.quantization import quantize_model
            model = quantize_model(model, quantized)
        else:
            model = copy.deepcopy(model)
        self._model = model
        self._device = model.device
        self._buckets = sorted({int(b) for b in prompt_buckets})
        if not self._buckets or self._buckets[0] < 1:
            raise InvalidArgumentError(
                f"prompt_buckets must be positive lengths, got "
                f"{prompt_buckets!r}")
        self._batch = int(batch_size)
        self._eos = eos_token_id
        self._C = int(cache_len or cfg.max_position)
        if self._buckets[-1] > self._C:
            raise InvalidArgumentError(
                f"largest prompt bucket ({self._buckets[-1]}) exceeds "
                f"cache_len ({self._C}) — a prompt must fit the cache")
        self._pool: Optional[PagePool] = None
        if self._paged:
            self._page = int(flag("kv_page_size")
                             if kv_page_size is None else kv_page_size)
            self._spec_k = max(int(flag("speculative_k")
                                   if speculative_k is None
                                   else speculative_k), 0)
            self._kv_pages = (int(kv_pages) if kv_pages is not None
                              else self._batch * (self._C // self._page))
            self._pool = self._new_pool()  # validates the page geometry
            # hand-off payloads carry whole prompt pages at ONE width:
            # enough pages for the largest prompt bucket, padded with -1
            # (the write-drop page)
            self._Gh = -(-self._buckets[-1] // self._page)
        self._ring_cache = None              # the dense ring, made once
        self._ring_lock = threading.Lock()
        # swaps land between device calls, never inside one
        self._weights_lock = threading.Lock()
        self._warm = False
        self._it_fast0: Optional[float] = None
        self._it_wide0: Optional[float] = None
        extra = (SLOT_COUNTERS + PAGED_COUNTERS + HANDOFF_COUNTERS
                 if self._paged else SLOT_COUNTERS)
        if self._moe_experts:
            extra = extra + MOE_COUNTERS
        if self._lora_cap:
            extra = extra + LORA_COUNTERS
        if tenancy is not None:
            extra = extra + TENANCY_COUNTERS
        self.metrics = ServingMetrics(name, extra_counters=extra)
        self.breaker = CircuitBreaker(name) if circuit_breaker else None
        self._retry_transient = bool(retry_transient)
        self._thread: Optional[threading.Thread] = None
        if self._continuous:
            # pull mode: the decode loop is the consumer, taking requests
            # slot by slot (FCFS across buckets)
            self._batcher = MicroBatcher(
                self._route, None, pull=True, max_batch_size=batch_size,
                max_queue_delay_ms=max_queue_delay_ms,
                max_queue_depth=max_queue_depth, metrics=self.metrics,
                name=name)
            self._thread = threading.Thread(
                target=self._paged_loop if self._paged else self._slot_loop,
                name=f"{name}-decode", daemon=True)
            self._thread.start()
        else:
            self._batcher = MicroBatcher(
                self._route, self._run_batch, max_batch_size=batch_size,
                max_queue_delay_ms=max_queue_delay_ms,
                max_queue_depth=max_queue_depth, metrics=self.metrics,
                breaker=self.breaker,
                retry=(RetryPolicy.from_flags(name=f"{name}.runner")
                       if retry_transient else None),
                name=name)

    # -- device calls --------------------------------------------------------
    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return upload(np.asarray(a, np.int32), self._device)

    def _new_cache(self):
        return self._model.gpt.init_paged_cache(
            self._kv_pages, self._page, dtype=self._kv_qdtype())

    def _ring(self):
        """The dense ring KV cache, allocated on first use and kept for the
        engine's life (``[B,H,C,hd]`` per layer: ~604 MB at gpt_small
        width, B = 8, C = 1024, float32)."""
        with self._ring_lock:
            if self._ring_cache is None:
                self._ring_cache = self._model.gpt.init_cache(self._batch,
                                                              self._C)
            return self._ring_cache

    def _aids_arg(self, aidsv: Optional[np.ndarray] = None):
        """Per-slot adapter ids for a device call: ``None`` when the model
        has no LoRA tables (the calls are then exactly the LoRA-free
        ones), else a copy of ``aidsv`` (all ``-1`` when ``None``)."""
        if not self._lora_cap:
            return None
        if aidsv is None:
            aidsv = np.full((self._batch,), -1, np.int32)
        return np.asarray(aidsv, np.int32).copy()

    def _prefill(self, ids, positions, lens, cache, aids=None):
        """Prefill ``[B, Sb]`` prompts (``-1`` positions inert) into the
        ring; returns the ``[B]`` int32 greedy first tokens (on the
        device) and the ring."""
        with self._weights_lock:
            logits, cache = self._model.forward_cached(
                ids, positions, cache, gather_last=lens,
                adapter_ids=self._aids_arg(aids))
            return logits.argmax(-1).to(torch.int32), cache

    def _decode(self, tok, pos, cache, aids=None):
        """One ``[B, 1]`` decode step: ``tok`` the device tokens of the
        last step, ``pos`` the host positions (``-1`` = free slot),
        ``aids`` the per-slot adapter ids.  Returns the step's tokens (on
        the device) in a :class:`_Readback` — with an MoE model's routing
        counts once the engine is warm — and the ring."""
        with self._weights_lock, moe_stats.collect() as ms:
            logits, cache = self._model.forward_cached(
                tok[:, None], np.asarray(pos)[:, None], cache,
                adapter_ids=self._aids_arg(aids))
            tok = logits[:, 0].argmax(-1).to(torch.int32)
        counts = (ms.counts(self._moe_experts)
                  if self._moe_experts and self._warm else None)
        return tok, _Readback(tok, counts), cache

    def _fold_readback(self, rb: _Readback) -> np.ndarray:
        """Wait for a step's tokens; fold its routing counts, if any."""
        host = rb.numpy()
        if rb.counts is not None:
            self._moe_harvest(rb.counts.numpy())
        return host

    def _clear_rows(self, cache, rows):
        """Ring rows ``rows`` (host indices) as a fresh cache holds them:
        positions ``-1``, K/V zeros — what JAX's admission merges in from
        the fresh cache it prefills (``write_slots``), written in place
        for just these rows."""
        if not len(rows):
            return
        m = np.zeros(cache["pos"].shape[0], bool)
        m[rows] = True
        self._model.gpt.reset_slots(cache, m)
        r = upload(np.asarray(rows, np.int64), self._device)
        for layer in cache["layers"]:
            for t in layer.values():
                t.index_fill_(0, r, 0)

    def _admit(self, ids, positions, lens, mask, cache, tok, aids=None):
        """Slot admission: clear the masked rows (positions -1, K/V zeros,
        as in a fresh cache), prefill the group straight into their ring
        rows (the other rows at ``-1``: nothing of theirs is written, so
        live slots stay bit-identical), and take the admitted rows' first
        tokens."""
        self._clear_rows(cache, np.nonzero(mask)[0])
        first, cache = self._prefill(ids, positions, lens, cache, aids)
        m = upload(np.asarray(mask, bool), self._device)
        return torch.where(m, first, tok), cache

    def _evict(self, tok, cache, mask):
        m = upload(np.asarray(mask, bool), self._device)
        self._model.gpt.reset_slots(cache, m)
        return tok.masked_fill(m, 0), cache

    def _export(self, cache, idx):
        """Hand-off export: the pages ``idx`` (``-1`` = drop page) as one
        host payload (see :meth:`GPTModel.gather_pages`)."""
        return self._model.gpt.gather_pages(cache, idx)

    def _import(self, cache, kv, dst):
        """Hand-off import: a payload into the pages ``dst``."""
        return self._model.gpt.scatter_pages(cache, kv, dst)

    def _handoff_shape(self):
        """Shape of a :class:`KVHandoff` payload: whole pages for the
        largest prompt bucket, every layer's k and v in one array."""
        cfg = self._model.gpt.cfg
        hd = cfg.hidden_size // cfg.num_heads
        return (cfg.num_layers, 2, self._Gh, cfg.num_heads, self._page, hd)

    def _handoff_zero(self):
        """An all-zeros payload shaped and typed as :meth:`_export`'s (a
        ``(pages, scales)`` pair for quantized pools; fp8 pages as
        ``uint8`` bits, bf16 as ``int16``)."""
        shape = self._handoff_shape()
        host = {"int8": np.int8, "fp8": np.uint8}.get(self._quantized)
        if host is None:
            return np.zeros(shape, {"float32": np.float32,
                                    "bfloat16": np.int16}[
                self._model.gpt.cfg.dtype])
        return np.zeros(shape, host), np.zeros(shape[:-1], np.float32)

    # -- quantized serving ---------------------------------------------------
    @property
    def quant_active(self) -> bool:
        """True iff the model this engine serves from carries any
        int8/fp8 weight — its Linear forwards take the quantized leg
        exactly when this holds."""
        from ..slim.quantization import _is_quantized_dtype
        return any(_is_quantized_dtype(t.dtype)
                   for t in self._model.state_dict().values())

    def _kv_qdtype(self):
        """Page-pool storage dtype for this engine's quantization mode
        (``None`` = the model's float dtype)."""
        return {"int8": torch.int8,
                "fp8": torch.float8_e4m3fn}.get(self._quantized)

    # -- hot weight swaps ----------------------------------------------------
    def swap_weights(self, params_file: str) -> None:
        """Hot-swap the served weights from a ``.pdiparams`` side-file
        (``{"params", "buffers"[, "quantization"]}`` by dotted name — e.g.
        a ``slim.export_quantized`` artifact, from either package).  The
        tree, every shape and dtype, and the quantization tag must match
        the served tensors, or nothing is touched and
        ``InvalidArgumentError`` is raised; then every tensor is copied
        into the served one IN PLACE, between two device calls of the
        loop, so a later CUDA graph of the step would stay valid."""
        from ..framework import serialization
        from ..slim.quantization import weight_trees

        state = serialization.load(params_file)
        if not isinstance(state, dict) or "params" not in state:
            raise InvalidArgumentError(
                f"{params_file} is not a params side-file")
        tag = state.get("quantization")
        if tag is not None and tag != (self._quantized or "none"):
            raise InvalidArgumentError(
                f"{self.name}: {params_file} is a {tag!r}-quantized "
                f"artifact but this engine serves "
                f"{self._quantized or 'none'!r}")
        pairs = []
        for part, served, new in zip(
                ("params", "buffers"), weight_trees(self._model),
                (state["params"], state.get("buffers") or {})):
            if not isinstance(new, dict) or set(new) != set(served):
                raise InvalidArgumentError(
                    f"swap_weights: {params_file} {part} do not match the "
                    f"served model (different tree structure)")
            pairs += [(served[n], _swap_tensor(n, new[n], served[n]))
                      for n in sorted(served)]
        with self._weights_lock, torch.no_grad():
            for dst, src in pairs:
                dst.copy_(src)
        self.metrics.incr("weight_swaps")

    def reload_weights(self) -> None:
        """Re-read the weights of the model the engine was built over
        (e.g. after ``paddle_tpu_torch.load`` into it) into the engine's
        own copy, in place, between two device calls; a quantized engine
        re-quantizes them on the way in.  Counted in ``weight_swaps``."""
        targets = set()
        if self._quantized:
            from ..slim.quantization import (_is_quantized_dtype,
                                             _quantize_weight,
                                             _serving_targets)
            targets = {n for n, _ in _serving_targets(self._model)}
        served = self._model.state_dict()
        src = self._source.state_dict()
        with self._weights_lock, torch.no_grad():
            for name, t in served.items():
                layer, _, leaf = name.rpartition(".")
                if layer in targets and leaf == "weight":
                    w = src[name]
                    if _is_quantized_dtype(w.dtype):  # already codes
                        q, sc = w, src[f"{layer}.weight_scale"]
                    else:
                        q, sc = _quantize_weight(w, self._quantized)
                    t.copy_(q)
                    served[f"{layer}.weight_scale"].copy_(sc)
                elif not (layer in targets and leaf == "weight_scale"):
                    t.copy_(src[name])
        self.metrics.incr("weight_swaps")

    # -- multi-LoRA adapter table --------------------------------------------
    def _lora_tables(self) -> Dict[str, torch.Tensor]:
        """The served adapter tables by dotted name (``….lora_A`` /
        ``….lora_B`` / ``….lora_scale`` of the engine's own copy)."""
        if not self._lora_cap:
            raise InvalidArgumentError(
                f"{self.name}: model has no LoRA tables "
                f"(GPTConfig.lora_capacity == 0)")
        return {n: t for n, t in self._model.named_buffers()
                if n.rpartition(".")[2] in ("lora_A", "lora_B",
                                            "lora_scale")}

    def install_adapter(self, slot: int, adapter) -> None:
        """Hot-add ``adapter`` into table slot ``slot``: every site is
        validated first (``lora.write_adapter``'s rules), then the slot's
        rows of the engine's own tables are written IN PLACE under the
        weights lock, between two device calls, so no step sees a
        half-written slot.  Shapes and dtypes are kept; requests already
        decoding with this slot id take the new weights from their next
        step."""
        from ..lora.batched import _write_slot

        tables = self._lora_tables()
        with self._weights_lock, torch.no_grad():
            _write_slot(tables, slot, adapter)
        self._adapters[int(slot)] = adapter.name
        self.metrics.incr("adapter_installs")

    def remove_adapter(self, slot: int) -> None:
        """Hot-remove the adapter in table slot ``slot`` (its A / B rows
        zeroed in place, between device calls): slot id ``slot`` becomes a
        zero delta, the base model's tokens."""
        from ..lora.batched import _clear_slot

        tables = self._lora_tables()
        with self._weights_lock, torch.no_grad():
            _clear_slot(tables, slot)
        self._adapters.pop(int(slot), None)
        # a step racing the removal can at worst lose one hit on a slot
        # being cleared anyway; the counter never steers control flow
        self._adapter_hits[int(slot)] = 0
        self.metrics.incr("adapter_removals")

    @property
    def adapters(self) -> Dict[int, str]:
        """Installed adapter names by table slot (host-side view; like the
        JAX engine's, a ``swap_weights`` / ``reload_weights`` replaces the
        tables but not this view)."""
        return dict(self._adapters)

    # -- routing -------------------------------------------------------------
    def _route(self, inputs: Sequence) -> int:
        n = len(np.asarray(inputs[0]).reshape(-1))
        for i, b in enumerate(self._buckets):
            if n <= b:
                return i
        self.metrics.incr("bucket_misses")
        raise InvalidArgumentError(
            f"{self.name}: prompt length {n} exceeds the largest bucket "
            f"({self._buckets[-1]}) — add a bucket or truncate the prompt")

    def warmup(self) -> None:
        """Run every device path once on inert data so the kernels are
        built and the card initialized before live traffic.  Dense modes:
        the ring is allocated (once, for the engine's life), then one inert
        admission per prompt bucket and one inert decode step run on it
        (every position ``-1``: nothing is written).  Paged mode: one
        admission per bucket, the ``[B, 1+k]`` and ``[B, 1]`` steps (the
        best of two timed calls of each seeds the loop's wide-vs-fast cost
        model), the page-copy op, and the role's hand-off op."""
        with torch.no_grad():
            if self._paged:
                self._warmup_paged()
            else:
                self._warmup_dense()
        mark_warm()  # circuit re-opens from here on are hot-path flaps
        self._warm = True

    def _warmup_dense(self):
        B = self._batch
        cache = self._ring()
        tok = torch.zeros(B, dtype=torch.int32, device=self._device)
        none = np.zeros((B,), bool)
        for sb in self._buckets:
            tok, _ = self._admit(np.zeros((B, sb), np.int32),
                                 np.full((B, sb), -1, np.int32),
                                 np.ones((B,), np.int32), none, cache, tok)
        _, rb, _ = self._decode(tok, np.full((B,), -1, np.int64), cache)
        rb.numpy()

    def _warmup_paged(self):
        B, C = self._batch, self._C
        G = C // self._page
        pm0 = np.full((B, C), -1, np.int32)
        tb0 = np.full((B, G), -1, np.int32)
        cache = self._new_cache()
        for sb in self._buckets:
            pos = np.broadcast_to(np.arange(sb, dtype=np.int32), (B, sb))
            _, cache = self._padmit(np.zeros((B, sb), np.int32), pos,
                                    pm0, tb0, np.full((B,), sb, np.int32),
                                    cache)
        timed = {}
        for key, Tt in (("wide", 1 + self._spec_k), ("fast", 1)):
            pk = self._pack_step(np.zeros((B, Tt), np.int32),
                                 np.full((B, Tt), -1, np.int32))
            best = None
            for _ in range(3):  # first call is the untimed warm-up
                t0 = time.monotonic()
                _, cache = self._step(pk, cache)
                ms = (time.monotonic() - t0) * 1e3
                best = ms if best is None else min(best, ms)
            timed[key] = best
        if self._spec_k:
            self._it_wide0, self._it_fast0 = timed["wide"], timed["fast"]
        neg = np.full((B,), -1, np.int32)
        self._cow(cache, neg, neg)
        # the role's hand-off op, on inert -1 pages (the drop page only)
        idx0 = np.full((self._Gh,), -1, np.int32)
        if self._role == "prefill":
            self._export(cache, idx0)
        elif self._role == "decode":
            self._import(cache, self._handoff_zero(), idx0)

    # -- shared slot bookkeeping ---------------------------------------------
    def _expire_carry(self, carry: List[tuple]) -> List[tuple]:
        """Deadline sweep for requests held outside the queue
        (breaker-deferred admissions, restart re-admissions)."""
        now = time.monotonic()
        keep: List[tuple] = []
        for r, n in carry:
            if r.deadline_t is not None and now > r.deadline_t:
                self.metrics.incr("expired")
                if not r.future.done():
                    r.future.set_exception(ExecutionTimeoutError(
                        f"{self.name}: deadline exceeded after "
                        f"{(now - r.enqueue_t) * 1e3:.1f}ms awaiting a "
                        f"decode slot"))
            else:
                keep.append((r, n))
        return keep

    def _finish(self, s: dict, now: float):
        """Resolve one completed slot: future (its tokens, or the
        :class:`KVHandoff` a prefill-role slot produced), latency / token
        metrics, breaker success."""
        r: Request = s["req"]
        self.metrics.incr("completed")
        self.metrics.observe_latency_ms((now - r.enqueue_t) * 1e3)
        self.metrics.observe_span((s["t0"] - r.enqueue_t) * 1e3,
                                  (now - s["t0"]) * 1e3)
        self.metrics.observe_tokens(len(s["out"]), max(now - s["t0"], 1e-9))
        tenant = s.get("tenant")
        if tenant is not None:
            self.metrics.observe_tenant(tenant, (now - r.enqueue_t) * 1e3,
                                        len(s["out"]))
        if self.breaker is not None:
            self.breaker.record_success(0)
        if not r.future.done():
            res = s.get("result")
            r.future.set_result(res if res is not None
                                else np.asarray(s["out"], np.int32))

    def _fail_all(self, slots, carry, err):
        """``close(drain=False)``: fail every slot's and carried request."""
        for i, s in enumerate(slots):
            if s is not None and not s["req"].future.done():
                s["req"].future.set_exception(err)
            slots[i] = None
        for r, _ in carry:
            if not r.future.done():
                r.future.set_exception(err)

    def _restart(self, e: Exception, slots) -> List[tuple]:
        """A device failure mid-flight: transient errors requeue the
        in-flight requests (bounded per request: greedy decode is
        deterministic, so they regenerate the same tokens), others fail
        them.  Returns the survivors to re-admit."""
        if self.breaker is not None:
            self.breaker.record_failure(0)
        max_restarts = (max(int(flag("transient_max_retries")) - 1, 0)
                        if self._retry_transient else 0)
        survivors: List[tuple] = []
        for i, s in enumerate(slots):
            slots[i] = None
            if s is None:
                continue
            if is_transient(e) and s["restarts"] < max_restarts:
                survivors.append((s["req"], s["restarts"] + 1))
            else:
                self.metrics.incr("errors")
                if not s["req"].future.done():
                    s["req"].future.set_exception(e)
        if survivors:
            self.metrics.incr("restarts")
        return survivors

    def _poll_admissions(self, free, carry, idle_wait: bool):
        """FCFS candidates for the free slots: carried requests first, then
        the queue (blocking up to 50 ms when the loop is idle).  An open
        circuit DEFERS admission (the requests wait in carry under the
        deadline sweep), never sheds.  Returns ``(take, carry,
        blocked_wait)``."""
        q = self._batcher
        take = carry[:len(free)]
        carry = carry[len(take):]
        want = len(free) - len(take)
        blocked_wait = False
        if want > 0:
            wait = 0.05 if idle_wait and not take else 0.0
            blocked_wait = wait > 0
            take += [(r, 0) for r in q.poll(want, wait_s=wait)]
        if take and self.breaker is not None and not self.breaker.allow(0):
            carry = take + carry
            take = []
            q.sweep()
        return take, carry, blocked_wait

    def _poll_tenants(self, ten, carry, idle_wait: bool):
        """Weighted-fair candidates under a :class:`TenantScheduler`: ALL
        waiting requests (carry plus a widened queue window of up to
        ``2 B`` admissible ones), so the stride order can pass a tenant
        that monopolises the FIFO; over-budget tenants' requests defer
        back to carry with their arrival order kept.  An open circuit
        defers as in :meth:`_poll_admissions`.  Returns ``(cand, carry,
        blocked_wait)``; the caller admits at most one per free slot and
        carries the rest."""
        q = self._batcher
        cand = carry
        # the window bounds ADMISSIBLE work: a throttled tenant's deferred
        # backlog must not stop new arrivals from being polled
        n_adm = sum(1 for rc in cand
                    if not ten.is_throttled(self._tenant_of(rc[0])))
        want = max(2 * self._batch - n_adm, 0)
        wait = 0.05 if idle_wait and not cand else 0.0
        blocked_wait = wait > 0
        if want > 0:
            cand = cand + [(r, 0) for r in q.poll(want, wait_s=wait)]
        cand, deferred = ten.schedule(
            cand, tenant_of=lambda rc: self._tenant_of(rc[0]),
            cost_of=lambda rc: max(int(rc[0].meta[0]), 1))
        carry = deferred
        if cand and self.breaker is not None and not self.breaker.allow(0):
            carry = cand + carry
            cand = []
            q.sweep()
        return cand, carry, blocked_wait

    # -- the dense continuous loop -------------------------------------------
    def _slot_loop(self):
        with torch.no_grad():
            self._slot_loop_body()

    def _slot_loop_body(self):
        """The persistent decode loop — sole owner of the ring.

        Per iteration: admit queued requests into free slots (one
        admission for the group, padded to its largest bucket), dispatch
        the next decode step for the live slots, then harvest the OLDEST
        in-flight step — so one step is always queued on the card while
        the host books the previous one.  Free slots ride along as
        position ``-1`` rows: they write nothing, attend to nothing, and
        their argmax is never harvested."""
        q = self._batcher
        B = self._batch
        slots: List[Optional[dict]] = [None] * B
        gens = [0] * B                       # guards stale in-flight tokens
        pos = np.full((B,), -1, np.int64)    # next decode position (-1 free)
        aidsv = np.full((B,), -1, np.int32)  # per-slot adapter ids
        cache = tok = None                   # the ring and the last tokens
        pending: deque = deque()             # in-flight steps, oldest first
        carry: List[tuple] = []              # (Request, n_restarts)
        last_gauges = 0.0
        try:
            while True:
                try:
                    closing = q.closing
                    if closing and not q.drain_on_close:
                        self._fail_all(slots, carry, UnavailableError(
                            f"{self.name}: dropped at shutdown "
                            f"(drain=False)"))
                        pending.clear()
                        q.poll(B, 0.0)  # fails everything still queued
                        return
                    live = [i for i in range(B) if slots[i] is not None]
                    free = [i for i in range(B) if slots[i] is None]
                    if (closing and not live and not pending and not carry
                            and q.queue_depth == 0):
                        return

                    # ---- admission: FCFS into the free slots
                    take: List[tuple] = []
                    blocked_wait = False
                    if carry:
                        carry = self._expire_carry(carry)
                    if free:
                        take, carry, blocked_wait = self._poll_admissions(
                            free, carry, idle_wait=not live and not pending)
                    if take:
                        if cache is None:
                            cache = self._ring()
                            self._clear_rows(cache, np.arange(B))  # fresh
                            tok = torch.zeros(B, dtype=torch.int32,
                                              device=self._device)
                        Sb = self._buckets[max(r.bucket for r, _ in take)]
                        ids = np.zeros((B, Sb), np.int32)
                        pp = np.full((B, Sb), -1, np.int32)
                        lens = np.ones((B,), np.int32)
                        mask = np.zeros((B,), bool)
                        targets = []
                        now = time.monotonic()
                        for (r, nre), i in zip(take, free):
                            prompt = np.asarray(r.inputs[0],
                                                np.int32).reshape(-1)
                            L = len(prompt)
                            ids[i, :L] = prompt
                            pp[i, :L] = np.arange(L)
                            lens[i] = L
                            mask[i] = True
                            gens[i] += 1
                            pos[i] = L
                            budget, tenant, aid = r.meta
                            aidsv[i] = aid
                            slots[i] = {"req": r, "budget": int(budget),
                                        "out": [], "t0": now,
                                        "tenant": tenant, "restarts": nre}
                            targets.append((i, gens[i]))
                        fault_point("serving.decode")
                        tok, cache = self._admit(ids, pp, lens, mask, cache,
                                                 tok, aidsv)
                        pending.append((_Readback(tok), targets))
                        self.metrics.incr("admitted", len(take))
                        self.metrics.incr("batches")
                        live = [i for i in range(B) if slots[i] is not None]
                    elif (free and not closing
                          and (carry or q.queue_depth > 0)):
                        # free slots + waiting requests + nothing admitted
                        self.metrics.incr("starved_steps")
                        if self._warm:
                            self.metrics.incr("starved_steps_after_warm")

                    # ---- decode dispatch (at most 2 steps in flight) ----
                    dispatched = bool(take)
                    if live and len(pending) < 2:
                        tok, rb, cache = self._decode(tok, pos, cache,
                                                      aidsv)
                        pending.append((rb, [(i, gens[i]) for i in live]))
                        for i in live:
                            pos[i] += 1
                        self.metrics.incr("decode_steps")
                        self.metrics.observe_occupancy(len(live) / B)
                        dispatched = True

                    # ---- harvest the oldest in-flight step ----
                    if pending and (len(pending) >= 2 or not dispatched):
                        rb, targets = pending.popleft()
                        host = self._fold_readback(rb)  # the one wait
                        finished = np.zeros((B,), bool)
                        now = time.monotonic()
                        for i, g in targets:
                            s = slots[i]
                            if s is None or gens[i] != g:
                                continue  # a finished slot's stale token
                            t = int(host[i])
                            s["out"].append(t)
                            if (len(s["out"]) >= s["budget"]
                                    or (self._eos is not None
                                        and t == self._eos)):
                                finished[i] = True
                                self._finish(s, now)
                                slots[i] = None
                                pos[i] = -1
                                aidsv[i] = -1
                        if finished.any():
                            tok, cache = self._evict(tok, cache, finished)
                            self.metrics.incr("evicted",
                                              int(finished.sum()))
                        dispatched = True

                    if not dispatched and not blocked_wait:
                        time.sleep(0.002)  # deferred/idle: don't spin hot

                    now = time.monotonic()
                    if now - last_gauges >= 0.1:
                        last_gauges = now
                        self._update_gauges(slots, carry)
                except Exception as e:
                    carry = self._restart(e, slots) + carry
                    pos[:] = -1
                    aidsv[:] = -1
                    pending.clear()
                    cache = tok = None
        finally:
            self._update_gauges(slots, carry)
            q.consumer_done()

    # -- legacy batch execution ----------------------------------------------
    def _run_batch(self, bucket: int, requests: List[Request]
                   ) -> List[np.ndarray]:
        """One legacy batch, run to completion: prefill every request into
        the ring (cleared first, as JAX's fresh cache), then ``[B, 1]``
        decode steps, reading each step's tokens back, until the last
        request ends.
        Dummy rows (past ``len(requests)``) decode garbage nobody reads,
        as in JAX."""
        with torch.no_grad():
            B, Sb = self._batch, self._buckets[bucket]
            ids = np.zeros((B, Sb), np.int32)
            positions = np.full((B, Sb), -1, np.int32)
            lens = np.ones((B,), np.int32)  # dummy rows: 1 unread slot
            budgets = np.zeros((B,), np.int64)
            aidsv = np.full((B,), -1, np.int32)
            for i, r in enumerate(requests):
                prompt = np.asarray(r.inputs[0], np.int32).reshape(-1)
                ids[i, :len(prompt)] = prompt
                positions[i, :len(prompt)] = np.arange(len(prompt))
                lens[i] = len(prompt)
                budgets[i] = int(r.meta[0])
                aidsv[i] = int(r.meta[2])
            t0 = time.monotonic()
            cache = self._ring()
            self._clear_rows(cache, np.arange(B))  # a fresh cache, as JAX's
            tok, cache = self._prefill(ids, positions, lens, cache, aidsv)
            out: List[List[int]] = [[] for _ in range(B)]
            done = np.array([i >= len(requests) for i in range(B)])
            n_tokens = 0
            n_step = 0  # decode offset past the prompt
            rb = _Readback(tok)
            while True:
                host_tok = self._fold_readback(rb)
                for i in range(len(requests)):
                    if done[i]:
                        continue
                    out[i].append(int(host_tok[i]))
                    n_tokens += 1
                    if (len(out[i]) >= budgets[i]
                            or (self._eos is not None
                                and host_tok[i] == self._eos)):
                        done[i] = True
                if done.all():
                    break
                tok, rb, cache = self._decode(tok, lens + n_step, cache,
                                              aidsv)
                self.metrics.incr("decode_steps")
                n_step += 1
            self.metrics.observe_tokens(n_tokens, time.monotonic() - t0)
            return [np.asarray(o, np.int32) for o in out[:len(requests)]]

    # -- the paged loop ------------------------------------------------------
    def _padmit(self, ids, positions, pos_map, table, lens, cache,
                aids=None):
        """Admission prefill straight into the pool: each slot writes only
        its own pages (padding rows land in the write-drop page).  Returns
        the first greedy token per slot (host) and the pool."""
        aids = self._aids_arg(aids)
        with self._weights_lock:
            logits, cache = self._model.forward_paged(
                self._to_dev(ids), self._to_dev(positions),
                self._to_dev(pos_map), self._to_dev(table), cache,
                gather_last=self._to_dev(lens),
                adapter_ids=None if aids is None else self._to_dev(aids))
            return logits.argmax(-1).cpu().numpy(), cache

    def _step(self, packed: np.ndarray, cache):
        """The unified decode/verify step over a ``[B, 2T + C + G (+ 1)]``
        int32 pack (``ids | positions | pos_map | table``, plus the
        per-slot adapter-id column of a LoRA model: one host→device
        transfer).  ``out[:, j]`` is the greedy next token after consuming
        ``ids[:, :j+1]``."""
        C = self._C
        G = C // self._page
        L = 1 if self._lora_cap else 0
        Tp = (packed.shape[1] - C - G - L) // 2
        pk = self._to_dev(packed)
        with self._weights_lock, moe_stats.collect() as ms:
            logits, cache = self._model.forward_paged(
                pk[:, :Tp], pk[:, Tp:2 * Tp], pk[:, 2 * Tp:2 * Tp + C],
                pk[:, 2 * Tp + C:2 * Tp + C + G], cache,
                adapter_ids=pk[:, -1].contiguous() if L else None)
            host = logits.argmax(-1).cpu().numpy()
        # an MoE model's routing counts; warm-up's dummy data is not counted
        if self._moe_experts and self._warm:
            self._moe_harvest(ms.counts(self._moe_experts).cpu().numpy())
        return host, cache

    def _moe_harvest(self, counts: np.ndarray):
        """Fold one step's ``[2, E]`` (routed, dropped) counts into the
        metrics: token totals, the post-warm sampled / overflow step
        counters and the overflow-fraction / dead-expert gauges."""
        routed, dropped = int(counts[0].sum()), int(counts[1].sum())
        self._moe_routed_cum += counts[0].astype(np.int64)
        m = self.metrics
        m.incr("moe_routed_tokens", routed)
        m.incr("moe_dropped_tokens", dropped)
        m.incr("moe_sampled_steps_after_warm")
        if dropped > 0:
            m.incr("moe_overflow_steps_after_warm")
        total = routed + dropped
        m.set_gauge("moe_overflow_frac", (dropped / total) if total else 0.0)
        if int(self._moe_routed_cum.sum()) > 0:
            m.set_gauge("moe_dead_experts",
                        int((self._moe_routed_cum == 0).sum()))

    def _cow(self, cache, src: np.ndarray, dst: np.ndarray):
        return self._model.gpt.copy_pages(cache, self._to_dev(src),
                                          self._to_dev(dst))

    def _new_pool(self) -> PagePool:
        return PagePool(self._batch, self._kv_pages, self._page, self._C)

    def _pack_step(self, ids: np.ndarray, positions: np.ndarray,
                   pos_map: Optional[np.ndarray] = None,
                   table: Optional[np.ndarray] = None,
                   aids: Optional[np.ndarray] = None) -> np.ndarray:
        """One ``[B, 2T + C + G]`` int32 row per slot carrying every
        per-step host input (``ids | positions | pos_map | table``), plus
        one trailing per-slot adapter-id column when the model has LoRA
        tables; ``None`` pos_map / table / aids mean all ``-1``.  The
        concatenate also snapshots the host-owned pool state."""
        B, C = self._batch, self._C
        G = C // self._page
        if pos_map is None:
            pos_map = np.full((B, C), -1, np.int32)
        if table is None:
            table = np.full((B, G), -1, np.int32)
        cols = [np.asarray(ids, np.int32), np.asarray(positions, np.int32),
                np.asarray(pos_map, np.int32), np.asarray(table, np.int32)]
        if self._lora_cap:
            cols.append(self._aids_arg(aids).reshape(B, 1))
        return np.concatenate(cols, axis=1)

    @staticmethod
    def _ngram_drafts(hist: List[int], k: int, n: int = 2) -> List[int]:
        """Prompt-lookup proposer: find the most recent earlier occurrence
        of the history's final ``n``-gram and propose the ``k`` tokens
        that followed it."""
        if k <= 0 or len(hist) < n + 1:
            return []
        tail = hist[-n:]
        for s in range(len(hist) - n - 1, -1, -1):
            if hist[s:s + n] == tail:
                return [int(t) for t in hist[s + n: s + n + k]]
        return []

    @staticmethod
    def _unpack_paged(r: Request):
        """Paged request meta ``(budget, prefix_key, prefix_len, handoff,
        tenant, adapter_id)`` as ``(prompt, prefix_key, prefix_len,
        budget, handoff, tenant, adapter_id)`` — ``handoff`` is ``None``
        for a plain request, ``True`` to produce a :class:`KVHandoff`, or
        one to adopt (its adapter id is this request's, as in JAX)."""
        budget, key, plen, hand, tenant, aid = r.meta
        prompt = np.asarray(r.inputs[0], np.int32).reshape(-1)
        return (prompt, key, min(int(plen), len(prompt)), int(budget),
                hand, tenant, int(aid))

    @staticmethod
    def _tenant_of(r: Request) -> Optional[str]:
        """Tenant name off a request's meta (paged 6-tuple or dense
        3-tuple), ``None`` for untagged requests."""
        m = r.meta
        if isinstance(m, tuple):
            if len(m) >= 6:
                return m[4]
            if len(m) == 3:
                return m[1]
        return None

    def _paged_loop(self):
        with torch.no_grad():
            self._paged_loop_body()

    def _paged_loop_body(self):
        """The persistent paged decode loop — sole owner of the device
        pool AND the host page accounting (``PagePool``).

        Per iteration: admit queued requests FCFS while the free list
        covers their page demand, then one unified decode/verify step for
        all live slots with n-gram drafts in the extra columns, then
        immediate harvest — accept the longest draft prefix matching the
        model's own argmax, invalidate the rest via the position map.
        Hand-off adoptions map fresh pages and import the donor's KV
        instead of prefilling; a prefill-role slot exports its prompt's
        pages right after its prefill and turns over.  CoW page copies
        from admission / first-divergent-write are dispatched before the
        step they protect.  Pool exhaustion mid-decode preempts the
        NEWEST slot.  The loop is serialized because drafting and page
        accounting need the previous step's tokens before the next
        dispatch.
        """
        q = self._batcher
        B, C, page = self._batch, self._C, self._page
        k_max, eos = self._spec_k, self._eos
        T = 1 + k_max
        slots: List[Optional[dict]] = [None] * B
        pos = np.full((B,), -1, np.int64)  # next write position (-1 = free)
        aidsv = np.full((B,), -1, np.int32)  # per-slot adapter ids
        ten = self._tenancy
        pool = self._pool
        cache = None                       # device pool (per-layer K/V)
        carry: List[tuple] = []            # (Request, n_restarts) to re-admit
        last_gauges = 0.0
        # self-measured iteration costs (ms) of the [B, 1] step vs the
        # wide [B, T] verify step — seeded by warmup, refined online
        it_fast: Optional[float] = self._it_fast0
        it_wide: Optional[float] = self._it_wide0

        def dispatch_cow(pairs):
            # chunk (src, dst, owner_slot) copies through the fixed-[B]
            # CoW op; -1 entries land in the write-drop page
            nonlocal cache
            while pairs:
                chunk, pairs = pairs[:B], pairs[B:]
                src = np.full((B,), -1, np.int32)
                dst = np.full((B,), -1, np.int32)
                for j, (s_, d_, _own) in enumerate(chunk):
                    src[j], dst[j] = s_, d_
                cache = self._cow(cache, src, dst)

        def preempt_newest() -> Optional[int]:
            victims = [v for v in range(B) if slots[v] is not None]
            if not victims:
                return None
            v = max(victims, key=lambda i: (slots[i]["t0"], i))
            vs = slots[v]
            pool.release(v)
            slots[v] = None
            pos[v] = -1
            aidsv[v] = -1
            # regeneration from the prompt is deterministic greedy
            carry.insert(0, (vs["req"], vs["restarts"]))
            self.metrics.incr("preempted")
            return v

        def evict(i: int, now: float):
            pool.release(i)
            self._finish(slots[i], now)
            slots[i] = None
            pos[i] = -1
            aidsv[i] = -1

        try:
            while True:
                try:
                    closing = q.closing
                    if closing and not q.drain_on_close:
                        self._fail_all(slots, carry, UnavailableError(
                            f"{self.name}: dropped at shutdown "
                            f"(drain=False)"))
                        q.poll(B, 0.0)  # fails everything still queued
                        return
                    live = [i for i in range(B) if slots[i] is not None]
                    free = [i for i in range(B) if slots[i] is None]
                    if (closing and not live and not carry
                            and q.queue_depth == 0):
                        return

                    # ---- tenant budget enforcement: an over-budget
                    # tenant's live slots preempt through the same
                    # deterministic release path as pool exhaustion; the
                    # requeued requests regenerate bit-identically once
                    # the tenant is back in budget
                    if ten is not None and live:
                        over = ten.over_budget()
                        if over:
                            npre = 0
                            for i in list(live):
                                s = slots[i]
                                if s is None or s.get("tenant") not in over:
                                    continue
                                pool.release(i)
                                carry.insert(0, (s["req"], s["restarts"]))
                                ten.note_preempted(s.get("tenant"))
                                slots[i] = None
                                pos[i] = -1
                                aidsv[i] = -1
                                npre += 1
                            if npre:
                                self.metrics.incr("preempted", npre)
                                self.metrics.incr("tenant_preempted", npre)
                                live = [i for i in range(B)
                                        if slots[i] is not None]
                                free = [i for i in range(B)
                                        if slots[i] is None]

                    # ---- admission: FCFS (or weighted-fair under a
                    # TenantScheduler), gated by the breaker AND the page
                    # budget; neither sheds — deferred requests wait in
                    # carry under the deadline sweep
                    take: List[tuple] = []
                    blocked_wait = False
                    if carry:
                        carry = self._expire_carry(carry)
                    if free:
                        if ten is None:
                            cand, carry, blocked_wait = \
                                self._poll_admissions(free, carry,
                                                      idle_wait=not live)
                        else:
                            cand, carry, blocked_wait = self._poll_tenants(
                                ten, carry, idle_wait=not live)
                        budget_pages = pool.free_pages
                        for ci, (r, nre) in enumerate(cand):
                            if len(take) >= len(free):
                                # widened tenancy window: surplus ordered
                                # candidates wait their turn in carry
                                carry = cand[ci:] + carry
                                break
                            prompt, key, _, _, hand, _, _ = \
                                self._unpack_paged(r)
                            if isinstance(hand, KVHandoff):
                                # adoption maps fresh private pages only
                                need = -(-hand.length // page)
                            else:
                                need = pool.pages_needed(prompt, key)
                            if need > budget_pages and ci == 0 and not live:
                                # nothing left to preempt: reclaim every
                                # registered prefix before giving up
                                pool.drop_all_prefixes()
                                budget_pages = pool.free_pages
                                if not isinstance(hand, KVHandoff):
                                    need = pool.pages_needed(prompt, key)
                            if need > budget_pages:
                                # head-of-line blocks: keep FCFS order
                                carry = cand[ci:] + carry
                                break
                            take.append((r, nre))
                            budget_pages -= need
                    pre: List[tuple] = []  # (request, slot) to prefill
                    if take:
                        if cache is None:
                            cache = self._new_cache()
                        now = time.monotonic()
                        # hand-off adoptions first: no prefill at all — map
                        # fresh pages, import the donor's KV, seed the slot
                        # with the donor's first token; decode resumes at
                        # position `length` as if prefilled here
                        n_adopted = n_done = 0
                        for (r, nre), i in zip(take, free):
                            prompt, _, _, budget, hand, tenant, aid = \
                                self._unpack_paged(r)
                            if not isinstance(hand, KVHandoff):
                                pre.append(((r, nre), i))
                                continue
                            pool.adopt(i, hand.length)
                            npg = -(-hand.length // page)
                            dst = np.full((self._Gh,), -1, np.int32)
                            dst[:npg] = pool.table[i, :npg]
                            cache = self._import(cache, hand.kv, dst)
                            t = int(hand.first_token)
                            slots[i] = {"req": r, "budget": budget,
                                        "out": [t], "t0": now,
                                        "restarts": nre, "tenant": tenant,
                                        "hist": [int(x) for x in prompt]
                                        + [t]}
                            pos[i] = hand.length
                            aidsv[i] = aid
                            if ten is not None and tenant is not None:
                                ten.charge(tenant, 1)
                            n_adopted += 1
                            if (hand.done or budget <= 1
                                    or (eos is not None and t == eos)):
                                evict(i, time.monotonic())
                                n_done += 1
                        if n_adopted:
                            self.metrics.incr("handoffs_in", n_adopted)
                            self.metrics.incr("admitted", n_adopted)
                        if n_done:
                            self.metrics.incr("evicted", n_done)
                    if pre:
                        Sb = self._buckets[max(r.bucket
                                               for (r, _), _ in pre)]
                        ids = np.zeros((B, Sb), np.int32)
                        pp = np.full((B, Sb), -1, np.int32)
                        lens = np.ones((B,), np.int32)
                        cow_pairs: List[tuple] = []
                        to_register: List[tuple] = []
                        admitted: List[int] = []
                        for (r, nre), i in pre:
                            prompt, key, plen, budget, hand, tenant, aid = \
                                self._unpack_paged(r)
                            pairs, shared = pool.admit(i, prompt, key)
                            cow_pairs += [(s_, d_, i) for s_, d_ in pairs]
                            L = len(prompt)
                            ids[i, :L - shared] = prompt[shared:]
                            pp[i, :L - shared] = np.arange(shared, L)
                            lens[i] = L - shared
                            pos[i] = L
                            aidsv[i] = aid
                            slots[i] = {"req": r, "budget": budget,
                                        "out": [], "t0": now,
                                        "restarts": nre, "tenant": tenant,
                                        "handoff": hand is True,
                                        "hist": [int(t) for t in prompt]}
                            admitted.append(i)
                            if key is not None and plen > 0:
                                # registered AFTER this prefill lands, so
                                # same-batch siblings never map pages whose
                                # boundary CoW would copy data not yet
                                # written
                                to_register.append((key, i, prompt[:plen]))
                        dispatch_cow(cow_pairs)
                        fault_point("serving.decode")
                        host_first, cache = self._padmit(
                            ids, pp, pool.pos_map, pool.table, lens, cache,
                            aidsv)
                        for key, i, toks in to_register:
                            pool.register_prefix(key, i, toks)
                        now = time.monotonic()
                        n_evicted = 0
                        for i in admitted:
                            s = slots[i]
                            t = int(host_first[i])
                            s["out"].append(t)
                            if ten is not None and s.get("tenant"):
                                ten.charge(s["tenant"], 1)
                            if s["handoff"]:
                                # produce: export the prompt's pages while
                                # they are still mapped and resolve with the
                                # KVHandoff (the first token rides along);
                                # the slot turns over at once
                                L = len(s["hist"])
                                npg = -(-L // page)
                                idx = np.full((self._Gh,), -1, np.int32)
                                idx[:npg] = pool.table[i, :npg]
                                s["result"] = KVHandoff(
                                    np.asarray(s["hist"], np.int32), t,
                                    self._export(cache, idx), L,
                                    bool(s["budget"] <= 1
                                         or (eos is not None and t == eos)))
                                self.metrics.incr("handoffs_out")
                                evict(i, now)
                                n_evicted += 1
                                continue
                            s["hist"].append(t)
                            if (len(s["out"]) >= s["budget"]
                                    or (eos is not None and t == eos)):
                                evict(i, now)
                                n_evicted += 1
                        self.metrics.incr("admitted", len(admitted))
                        self.metrics.incr("batches")
                        if n_evicted:
                            self.metrics.incr("evicted", n_evicted)
                    if take:
                        live = [i for i in range(B) if slots[i] is not None]
                        if ten is not None:
                            for r, _ in take:
                                ten.note_admitted(self._tenant_of(r))
                    elif (free and not closing
                          and (carry or q.queue_depth > 0)):
                        if (ten is not None and carry
                                and q.queue_depth == 0
                                and all(ten.is_throttled(self._tenant_of(r))
                                        for r, _ in carry)):
                            # every waiting request belongs to an
                            # over-budget tenant: throttling by design,
                            # not starvation
                            self.metrics.incr("tenant_throttled_steps")
                        else:
                            # free slots + waiting requests + nothing
                            # admitted
                            self.metrics.incr("starved_steps")
                            if self._warm:
                                self.metrics.incr("starved_steps_after_warm")
                    if (ten is not None and self._warm and carry
                            and any(slots[i] is None for i in range(B))):
                        # an IN-budget tenant still waiting while a slot
                        # sits idle after this step's admission pass (a
                        # full batch is contention, not starvation)
                        seen_tn = set()
                        for r, _ in carry:
                            tn = self._tenant_of(r)
                            if (tn is None or tn in seen_tn
                                    or ten.is_throttled(tn)):
                                continue
                            seen_tn.add(tn)
                            ten.note_starved(tn)
                        if seen_tn:
                            self.metrics.incr(
                                "tenant_starved_steps_after_warm")

                    # ---- unified decode/verify step (serialized) ----
                    dispatched = bool(take)
                    if live:
                        # pass 1 — propose: drafts only while the ring has
                        # spare slots (once positions reach C a multi-token
                        # step's later writes would destroy KV the earlier
                        # rows still read — the sliding-window region
                        # decodes one token per step)
                        props: Dict[int, List[int]] = {}
                        for i in live:
                            s = slots[i]
                            p = int(pos[i])
                            kq = min(k_max, max(C - 1 - p, 0))
                            if kq and s.get("spec_cool", 0) > 0:
                                # per-sequence backoff after rejections
                                s["spec_cool"] -= 1
                                kq = 0
                            props[i] = (self._ngram_drafts(s["hist"], kq)
                                        if kq else [])
                        # cost-aware go/no-go: go wide only when the
                        # predicted accepted tokens (per-slot acceptance
                        # EMA) beat the break-even bar from the loop's own
                        # measured step costs
                        drafting = [i for i in live if props[i]]
                        if it_fast is None:  # warmup ran after loop start
                            it_fast = self._it_fast0
                        if it_wide is None:
                            it_wide = self._it_wide0
                        if (drafting and it_fast is not None
                                and it_wide is not None
                                and it_wide > it_fast):
                            bar = len(live) * (it_wide - it_fast) / it_fast
                            pred = sum(slots[i].get("spec_ema", k_max)
                                       for i in drafting)
                            if pred < bar:
                                for i in drafting:
                                    props[i] = []
                        # pass 2 — commit: page accounting + step inputs
                        ids = np.zeros((B, T), np.int32)
                        pp = np.full((B, T), -1, np.int32)
                        cow_pairs = []
                        for i in list(live):
                            if slots[i] is None:
                                continue
                            p = int(pos[i])
                            prop = props.get(i, [])
                            while slots[i] is not None:
                                try:
                                    for j in range(len(prop) + 1):
                                        pr = pool.ensure_writable(i, p + j)
                                        if pr is not None:
                                            cow_pairs.append(
                                                (pr[0], pr[1], i))
                                    break
                                except MemoryError:
                                    v = preempt_newest()
                                    if v is not None:
                                        # drop the victim's pending copies:
                                        # its freed dst pages may be
                                        # re-allocated this very step
                                        cow_pairs = [t for t in cow_pairs
                                                     if t[2] != v]
                            s = slots[i]
                            if s is None:
                                continue  # preempted itself
                            for j in range(len(prop) + 1):
                                pool.pos_map[i, (p + j) % C] = p + j
                            ids[i, 0] = s["hist"][-1]
                            pp[i, 0] = p
                            for j, d in enumerate(prop):
                                ids[i, 1 + j] = d
                                pp[i, 1 + j] = p + 1 + j
                            s["_prop"] = prop
                        live = [i for i in range(B) if slots[i] is not None]
                    if live:
                        dispatch_cow(cow_pairs)
                        fault_point("serving.decode")
                        # no slot drafting this step -> the [B, 1] step
                        Td = T if any(slots[i].get("_prop")
                                      for i in live) else 1
                        t_step = time.monotonic()
                        host, cache = self._step(
                            self._pack_step(ids[:, :Td], pp[:, :Td],
                                            pool.pos_map, pool.table, aidsv),
                            cache)
                        dt = (time.monotonic() - t_step) * 1e3
                        if Td == 1:
                            it_fast = (dt if it_fast is None
                                       else 0.8 * it_fast + 0.2 * dt)
                        else:
                            it_wide = (dt if it_wide is None
                                       else 0.8 * it_wide + 0.2 * dt)
                        self.metrics.set_gauge("decode_step_ms", dt)
                        self.metrics.incr("decode_steps")
                        self.metrics.observe_occupancy(len(live) / B)
                        if self._lora_cap:
                            for i in live:
                                if aidsv[i] >= 0:
                                    self._adapter_hits[aidsv[i]] += 1
                        now = time.monotonic()
                        n_evicted = 0
                        for i in live:
                            s = slots[i]
                            prop = s.pop("_prop", [])
                            p = int(pos[i])
                            a = 0
                            while a < len(prop) and prop[a] == int(host[i, a]):
                                a += 1
                            # rejected drafts: their KV is stale — unmark
                            # it (overwritten when the real token arrives)
                            for j in range(a + 1, len(prop) + 1):
                                pool.pos_map[i, (p + j) % C] = -1
                            if prop:
                                self.metrics.incr("spec_drafted", len(prop))
                                self.metrics.incr("spec_accepted", a)
                                s["spec_ema"] = (
                                    0.5 * s.get("spec_ema", float(k_max))
                                    + 0.5 * a)
                                if a == 0:
                                    # exponential draft backoff (max 32
                                    # steps); any acceptance resets it
                                    s["spec_fail"] = min(
                                        s.get("spec_fail", 0) + 1, 5)
                                    s["spec_cool"] = 1 << s["spec_fail"]
                                else:
                                    s["spec_fail"] = 0
                            pos[i] = p + a + 1
                            done = False
                            n_out = 0
                            for j in range(a + 1):
                                t = int(host[i, j])
                                s["out"].append(t)
                                s["hist"].append(t)
                                n_out += 1
                                if (len(s["out"]) >= s["budget"]
                                        or (eos is not None and t == eos)):
                                    done = True
                                    break
                            if ten is not None and n_out and \
                                    s.get("tenant"):
                                ten.charge(s["tenant"], n_out)
                            if done:
                                evict(i, now)
                                n_evicted += 1
                        if n_evicted:
                            self.metrics.incr("evicted", n_evicted)
                        dispatched = True

                    if not dispatched and not blocked_wait:
                        time.sleep(0.002)  # deferred/idle: don't spin hot

                    now = time.monotonic()
                    if now - last_gauges >= 0.1:
                        last_gauges = now
                        self._update_gauges(slots, carry, pool)
                except Exception as e:
                    # a device failure mid-flight: a fresh pool and fresh
                    # page accounting for the requeued requests
                    carry = self._restart(e, slots) + carry
                    pos[:] = -1
                    aidsv[:] = -1
                    cache = None
                    pool = self._pool = self._new_pool()
        finally:
            self._update_gauges(slots, carry, pool)
            q.consumer_done()

    def _update_gauges(self, slots, carry, pool: Optional[PagePool] = None):
        q = self._batcher
        B = self._batch
        nlive = sum(1 for s in slots if s is not None)
        age = q.oldest_wait_ms()
        if carry:
            age = max(age, (time.monotonic() - carry[0][0].enqueue_t) * 1e3)
        m = self.metrics
        m.set_gauge("slot_occupancy", nlive / B)
        m.set_gauge("slots_free", B - nlive)
        m.set_gauge("queue_age_ms", age)
        if pool is not None:
            ps = pool.stats()
            m.set_gauge("kv_pages_free", ps["kv_pages_free"])
            m.set_gauge("kv_pages_shared", ps["kv_pages_shared"])
            m.set_gauge("kv_pages_leaked", ps["kv_pages_leaked"])
            m.set_counter("cow_copies", ps["cow_copies"])
        m.set_queue_depth(q.queue_depth + len(carry))

    # -- public API ----------------------------------------------------------
    def synthetic_inputs(self) -> np.ndarray:
        """A one-token prompt — a router's health probe decodes one token
        through the real admission + decode path."""
        return np.zeros((1,), np.int32)

    def submit(self, prompt_ids, max_new_tokens: int = 32,
               deadline_ms: Optional[float] = None,
               prefix_key: Optional[str] = None,
               prefix_len: int = 0, handoff=None,
               tenant: Optional[str] = None,
               adapter_id: Optional[int] = None) -> Future:
        """Async generation; resolves to the ``[<=max_new_tokens]`` int32
        array of greedily decoded tokens (stops after ``eos_token_id``).

        Paged mode only: ``prefix_key`` + ``prefix_len`` declare
        ``prompt_ids[:prefix_len]`` a shareable prefix (e.g. a system
        prompt): the first such request prefills it once and registers
        its pages; later requests with the same key (and the same leading
        tokens — verified, divergence falls back to a cold admission) map
        those pages copy-on-write.  Ignored by the dense modes.

        ``handoff`` (paged only) is the prefill/decode seam:
        ``handoff=True`` on a ``role="prefill"`` engine resolves the
        future with a :class:`KVHandoff` instead of decoding; passing
        that :class:`KVHandoff` (with the same ``prompt_ids``) to a
        ``role="decode"`` engine adopts its pages and decodes the
        remaining ``max_new_tokens - 1`` tokens, bit-identical to a
        co-located engine.  Plain submits work on every role.

        Multi-tenant serving (every mode): ``tenant`` tags the request for
        the engine's :class:`~.tenancy.TenantScheduler` (weighted-fair
        admission and token budgets, paged) and ``adapter_id`` selects a
        LoRA table slot for every step of this request (``None`` resolves
        through the tenant's registered spec when a scheduler is attached;
        the default is ``-1``, the base model, bitwise).  A decode-role
        engine adopting a hand-off uses the ``adapter_id`` of its own
        submit."""
        if max_new_tokens < 1:
            raise InvalidArgumentError("max_new_tokens must be >= 1")
        if adapter_id is not None:
            aid = int(adapter_id)
            if aid != -1 and not 0 <= aid < self._lora_cap:
                raise InvalidArgumentError(
                    f"{self.name}: adapter_id {aid} outside the adapter "
                    f"table (capacity {self._lora_cap}; -1 = base model)")
        elif tenant is not None and self._tenancy is not None:
            aid = int(self._tenancy.adapter_id(tenant))
        else:
            aid = -1
        if handoff is not None:
            if not self._paged:
                raise InvalidArgumentError(
                    f"{self.name}: handoff requires paged KV")
            if handoff is True:
                if self._role != "prefill":
                    raise InvalidArgumentError(
                        f"{self.name}: handoff=True (produce) requires "
                        f"role='prefill', this engine is "
                        f"role={self._role!r}")
            elif isinstance(handoff, KVHandoff):
                if self._role != "decode":
                    raise InvalidArgumentError(
                        f"{self.name}: adopting a KVHandoff requires "
                        f"role='decode', this engine is "
                        f"role={self._role!r}")
                if int(handoff.length) > self._C:
                    raise InvalidArgumentError(
                        f"{self.name}: handoff length {handoff.length} "
                        f"exceeds cache_len ({self._C})")
            else:
                raise InvalidArgumentError(
                    f"handoff must be None, True, or a KVHandoff, got "
                    f"{type(handoff).__name__}")
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        meta = ((int(max_new_tokens), prefix_key, int(prefix_len), handoff,
                 tenant, aid)
                if self._paged else (int(max_new_tokens), tenant, aid))
        return self._batcher.submit((prompt,), deadline_ms=deadline_ms,
                                    meta=meta)

    def generate(self, prompt_ids, max_new_tokens: int = 32,
                 timeout: Optional[float] = None, **kw) -> np.ndarray:
        """Blocking :meth:`submit` (extra keywords — ``adapter_id``,
        ``tenant``, ``prefix_key``… — pass through)."""
        return self.submit(prompt_ids, max_new_tokens, **kw).result(timeout)

    def stats(self) -> dict:
        snap = self.metrics.snapshot()
        snap["buckets"] = len(self._buckets)
        snap["continuous"] = self._continuous
        snap["paged"] = self._paged
        snap["role"] = self._role
        snap["quantization"] = self._quantized or "none"
        if self._pool is not None:
            snap.update(self._pool.stats())
        return snap

    def close(self, drain: bool = True, timeout: Optional[float] = None):
        self._batcher.close(drain=drain, timeout=timeout)
        if self._thread is not None:
            self._thread.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
