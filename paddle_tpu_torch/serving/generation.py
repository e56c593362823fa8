"""Paged-KV continuous-batching greedy generation for
``models.GPTForCausalLM`` (port of the paged mode of
``paddle_tpu.serving.generation.GenerationEngine``).

A persistent decode loop owns the ``B``-slot batch and ONE shared KV page
pool (``GPTModel.init_paged_cache``) behind a host-owned slot→page-table
indirection (``serving/paging.py``) — vLLM-style PagedAttention.  Each
iteration admits queued requests FCFS while the free list covers their
pages (prefill lands straight in the pool; pages of a shared
``prefix_key`` come mapped copy-on-write instead of recomputed), then runs
one unified decode/verify step for every live slot: column 0 is the plain
greedy token, columns ``1..k`` verify drafts from an n-gram proposer
(prompt lookup), and the longest draft prefix matching the model's own
argmax is accepted — token-identical to plain greedy, up to ``k+1``
tokens per step when text repeats.  When the pool runs dry mid-decode the
newest slot is preempted and requeued (greedy decode is deterministic, so
regeneration is bit-identical); eviction is a pure host table edit.

Steps where no slot drafts run a ``[B, 1]`` step instead of the wide
``[B, 1+k]`` verify step, and the wide step is gated by a cost model: the
loop times both and drafts only when the predicted accepted tokens out-earn
the wide step's extra cost, with per-slot exponential backoff after
zero-accept verifies.

Every admission and every step runs ``num_layers`` launches of the
``paged_flash_decode`` CUDA kernel on the card.  The engine follows the
model's device (``device="cpu"`` models serve through the kernels' plain
versions).

``quantized="int8" | "fp8"`` serves from a quantized copy of the model
(``slim.quantize_model``: int8 / fp8-e4m3 parallel-linear weights with
per-channel scales; the caller's model keeps its float weights) over an
int8 / float8_e4m3fn KV pool with float32 scale planes: four
``quantized_matmul`` kernel launches per layer per call on top of the
attention kernel's one.

A mixture-of-experts model (``GPTConfig.moe_experts > 0``) serves the
same way, with every block's expert FFN through two ``grouped_matmul``
kernel launches per call, and reports its routing health: each decode /
verify step runs inside ``moe.stats.collect()`` and folds its ``[2, E]``
routed / dropped counts into ``MOE_COUNTERS`` and the
``moe_overflow_frac`` / ``moe_dead_experts`` gauges (admissions are not
counted, as in the JAX package).  The JAX engine harvests each step's
counts one step late, so that reading them never stalls its
double-buffered loop; this loop already waits for every step's argmax,
so it reads the current step's counts right after it.  Warm-up steps
(dummy data) are not counted.

Not ported yet (ROADMAP queue A): the dense-ring and legacy
run-to-completion modes, prefill/decode hand-off roles (and the hand-off
of quantized ``(pages, scales)`` pairs), tenancy/LoRA, quantized MoE
engines,
``swap_weights`` / ``reload_weights``, tracing spans and the event-bus
snapshots, ``from_tuned``, and a CUDA-graph analog of the JAX engine's
closed compile set.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..framework.errors import (
    ExecutionTimeoutError,
    InvalidArgumentError,
    UnavailableError,
    UnimplementedError,
    is_transient,
)
from ..framework.flags import flag
from ..resilience import CircuitBreaker, mark_warm
from ..resilience.faults import fault_point
from ..moe import stats as moe_stats
from .batcher import MicroBatcher, Request
from .metrics import (MOE_COUNTERS, PAGED_COUNTERS, SLOT_COUNTERS,
                      ServingMetrics)
from .paging import PagePool

__all__ = ["GenerationEngine"]

_gen_counter = [0]


def _unported(what: str, item: str):
    return UnimplementedError(
        f"GenerationEngine: {what} is not ported yet (ROADMAP queue A, "
        f"{item})")


class GenerationEngine:
    """Dynamic-batching greedy decoder over a ``GPTForCausalLM``, paged KV.

    ``prompt_buckets`` — prompt lengths requests are padded up to;
    ``batch_size`` — the decode batch width (free slots run as inert
    ``-1``-position rows); ``cache_len`` — per-slot KV capacity (default
    ``cfg.max_position``; generation past it slides the window).
    ``kv_pages`` sizes the shared pool (default ``batch_size * cache_len /
    kv_page_size``); ``kv_page_size`` / ``speculative_k`` default to
    ``FLAGS_kv_page_size`` / ``FLAGS_speculative_k``.  ``paged`` /
    ``continuous`` default to ``FLAGS_paged_kv`` /
    ``FLAGS_continuous_batching``; only ``paged=True`` with continuous
    batching is ported.  ``quantized`` — ``None``, ``"int8"`` or
    ``"fp8"``: weights and KV pages at that precision (see the module
    docstring); ``model`` itself is left untouched.
    """

    def __init__(self, model, *, prompt_buckets: Sequence[int],
                 batch_size: int = 4, cache_len: Optional[int] = None,
                 max_queue_depth: int = 256,
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
        continuous = bool(flag("continuous_batching")
                          if continuous is None else continuous)
        paged = bool(flag("paged_kv") if paged is None else paged)
        if not continuous:
            raise _unported("the legacy run-batch-to-completion scheduler "
                            "(continuous=False)", "generation serving")
        if not paged:
            raise _unported("the dense ring KV mode (paged=False)",
                            "generation serving")
        if role != "any":
            raise _unported(f"role={role!r} (prefill/decode hand-off)",
                            "generation serving")
        if quantized is not None and quantized not in ("int8", "fp8"):
            raise InvalidArgumentError(
                f"quantized must be None, 'int8' or 'fp8', got "
                f"{quantized!r}")
        if tenancy is not None:
            raise _unported("tenancy", "MoE, LoRA and tenancy")
        # LoRA configs never get here: GPTModel rejects them
        cfg = model.gpt.cfg
        self._moe_experts = int(cfg.moe_experts or 0)
        if self._moe_experts and quantized is not None:
            raise _unported(f"quantized={quantized!r} for an MoE model",
                            "MoE, LoRA and tenancy")
        # per-expert routed totals since warm-up (the dead-expert gauge)
        self._moe_routed_cum = np.zeros(max(self._moe_experts, 1), np.int64)
        if name is None:
            _gen_counter[0] += 1
            name = f"generate#{_gen_counter[0]}"
        self.name = name
        model.eval()
        self._quantized = quantized
        if quantized is not None:
            # quantize once at construction, into the engine's own copy —
            # the caller's model keeps its float weights (training, other
            # engines untouched)
            from ..slim.quantization import quantize_model
            model = quantize_model(model, quantized)
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
        self._page = int(flag("kv_page_size")
                         if kv_page_size is None else kv_page_size)
        self._spec_k = max(int(flag("speculative_k")
                               if speculative_k is None else speculative_k),
                           0)
        if self._buckets[-1] > self._C:
            raise InvalidArgumentError(
                f"largest prompt bucket ({self._buckets[-1]}) exceeds "
                f"cache_len ({self._C}) — paged admission cannot map it")
        self._kv_pages = (int(kv_pages) if kv_pages is not None
                          else self._batch * (self._C // self._page))
        self._pool = self._new_pool()  # validates the page geometry
        self._warm = False
        self._it_fast0: Optional[float] = None
        self._it_wide0: Optional[float] = None
        extra = SLOT_COUNTERS + PAGED_COUNTERS
        if self._moe_experts:
            extra = extra + MOE_COUNTERS
        self.metrics = ServingMetrics(name, extra_counters=extra)
        self.breaker = CircuitBreaker(name) if circuit_breaker else None
        self._retry_transient = bool(retry_transient)
        self._batcher = MicroBatcher(self._route,
                                     max_queue_depth=max_queue_depth,
                                     metrics=self.metrics, name=name)
        self._thread = threading.Thread(target=self._paged_loop,
                                        name=f"{name}-decode", daemon=True)
        self._thread.start()

    # -- device calls --------------------------------------------------------
    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(
            self._device)

    def _new_cache(self):
        return self._model.gpt.init_paged_cache(
            self._kv_pages, self._page, dtype=self._kv_qdtype())

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

    def swap_weights(self, *_args, **_kw):
        raise _unported("swap_weights / reload_weights (and "
                        "slim.export_quantized artifacts)",
                        "generation serving")

    def _padmit(self, ids, positions, pos_map, table, lens, cache):
        """Admission prefill straight into the pool: each slot writes only
        its own pages (padding rows land in the write-drop page).  Returns
        the first greedy token per slot (host) and the pool."""
        logits, cache = self._model.forward_paged(
            self._to_dev(ids), self._to_dev(positions), self._to_dev(pos_map),
            self._to_dev(table), cache, gather_last=self._to_dev(lens))
        return logits.argmax(-1).cpu().numpy(), cache

    def _step(self, packed: np.ndarray, cache):
        """The unified decode/verify step over a ``[B, 2T + C + G]`` int32
        pack (``ids | positions | pos_map | table``, one host→device
        transfer).  ``out[:, j]`` is the greedy next token after consuming
        ``ids[:, :j+1]``."""
        C = self._C
        G = C // self._page
        Tp = (packed.shape[1] - C - G) // 2
        pk = self._to_dev(packed)
        with moe_stats.collect() as ms:
            logits, cache = self._model.forward_paged(
                pk[:, :Tp], pk[:, Tp:2 * Tp], pk[:, 2 * Tp:2 * Tp + C],
                pk[:, 2 * Tp + C:], cache)
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
        """Run every device path once on dummy data — one admission per
        prompt bucket, the ``[B, 1+k]`` and ``[B, 1]`` steps, the page-copy
        op — so the kernel is built and the card initialized before live
        traffic, and seed the loop's wide-vs-fast cost model with the best
        of two timed (synchronized) calls of each step width."""
        B, C = self._batch, self._C
        G = C // self._page
        pm0 = np.full((B, C), -1, np.int32)
        tb0 = np.full((B, G), -1, np.int32)
        with torch.no_grad():
            cache = self._new_cache()
            for sb in self._buckets:
                pos = np.broadcast_to(np.arange(sb, dtype=np.int32), (B, sb))
                _, cache = self._padmit(np.zeros((B, sb), np.int32), pos,
                                        pm0, tb0,
                                        np.full((B,), sb, np.int32), cache)
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
        mark_warm()  # circuit re-opens from here on are hot-path flaps
        self._warm = True

    # -- slot bookkeeping ----------------------------------------------------
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
        """Resolve one completed slot: future, latency/token metrics,
        breaker success."""
        r: Request = s["req"]
        self.metrics.incr("completed")
        self.metrics.observe_latency_ms((now - r.enqueue_t) * 1e3)
        self.metrics.observe_span((s["t0"] - r.enqueue_t) * 1e3,
                                  (now - s["t0"]) * 1e3)
        self.metrics.observe_tokens(len(s["out"]), max(now - s["t0"], 1e-9))
        if self.breaker is not None:
            self.breaker.record_success(0)
        if not r.future.done():
            r.future.set_result(np.asarray(s["out"], np.int32))

    def _new_pool(self) -> PagePool:
        return PagePool(self._batch, self._kv_pages, self._page, self._C)

    def _pack_step(self, ids: np.ndarray, positions: np.ndarray,
                   pos_map: Optional[np.ndarray] = None,
                   table: Optional[np.ndarray] = None) -> np.ndarray:
        """One ``[B, 2T + C + G]`` int32 row per slot carrying every
        per-step host input (``ids | positions | pos_map | table``);
        ``None`` pos_map/table mean all ``-1``.  The concatenate also
        snapshots the host-owned pool state."""
        B, C = self._batch, self._C
        G = C // self._page
        if pos_map is None:
            pos_map = np.full((B, C), -1, np.int32)
        if table is None:
            table = np.full((B, G), -1, np.int32)
        return np.concatenate(
            [np.asarray(ids, np.int32), np.asarray(positions, np.int32),
             np.asarray(pos_map, np.int32), np.asarray(table, np.int32)],
            axis=1)

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
        """Request meta: ``(prompt, prefix_key, prefix_len, budget)``."""
        budget, key, plen = r.meta
        prompt = np.asarray(r.inputs[0], np.int32).reshape(-1)
        return prompt, key, min(int(plen), len(prompt)), int(budget)

    # -- the decode loop -----------------------------------------------------
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
        CoW page copies from admission / first-divergent-write are
        dispatched before the step they protect.  Pool exhaustion
        mid-decode preempts the NEWEST slot.  The loop is serialized
        because drafting and page accounting need the previous step's
        tokens before the next dispatch.
        """
        q = self._batcher
        B, C, page = self._batch, self._C, self._page
        k_max, eos = self._spec_k, self._eos
        T = 1 + k_max
        max_restarts = (max(int(flag("transient_max_retries")) - 1, 0)
                        if self._retry_transient else 0)
        slots: List[Optional[dict]] = [None] * B
        pos = np.full((B,), -1, np.int64)  # next write position (-1 = free)
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
            # regeneration from the prompt is deterministic greedy
            carry.insert(0, (vs["req"], vs["restarts"]))
            self.metrics.incr("preempted")
            return v

        def evict(i: int, now: float):
            pool.release(i)
            self._finish(slots[i], now)
            slots[i] = None
            pos[i] = -1

        try:
            while True:
                try:
                    closing = q.closing
                    if closing and not q.drain_on_close:
                        err = UnavailableError(
                            f"{self.name}: dropped at shutdown "
                            f"(drain=False)")
                        for i in range(B):
                            s = slots[i]
                            if s is not None and not s["req"].future.done():
                                s["req"].future.set_exception(err)
                            slots[i] = None
                        for r, _ in carry:
                            if not r.future.done():
                                r.future.set_exception(err)
                        q.poll(B, 0.0)  # fails everything still queued
                        return
                    live = [i for i in range(B) if slots[i] is not None]
                    free = [i for i in range(B) if slots[i] is None]
                    if (closing and not live and not carry
                            and q.queue_depth == 0):
                        return

                    # ---- admission: FCFS, gated by the breaker AND the
                    # page budget; neither sheds — deferred requests wait
                    # in carry under the deadline sweep
                    take: List[tuple] = []
                    blocked_wait = False
                    if carry:
                        carry = self._expire_carry(carry)
                    if free:
                        cand = carry[:len(free)]
                        carry = carry[len(cand):]
                        want = len(free) - len(cand)
                        if want > 0:
                            wait = 0.05 if not live and not cand else 0.0
                            blocked_wait = wait > 0
                            cand += [(r, 0)
                                     for r in q.poll(want, wait_s=wait)]
                        if (cand and self.breaker is not None
                                and not self.breaker.allow(0)):
                            carry = cand + carry
                            cand = []
                            q.sweep()
                        budget_pages = pool.free_pages
                        for ci, (r, nre) in enumerate(cand):
                            prompt, key, _, _ = self._unpack_paged(r)
                            need = pool.pages_needed(prompt, key)
                            if need > budget_pages and ci == 0 and not live:
                                # nothing left to preempt: reclaim every
                                # registered prefix before giving up
                                pool.drop_all_prefixes()
                                budget_pages = pool.free_pages
                                need = pool.pages_needed(prompt, key)
                            if need > budget_pages:
                                # head-of-line blocks: keep FCFS order
                                carry = cand[ci:] + carry
                                break
                            take.append((r, nre))
                            budget_pages -= need
                    if take:
                        if cache is None:
                            cache = self._new_cache()
                        now = time.monotonic()
                        Sb = self._buckets[max(r.bucket for r, _ in take)]
                        ids = np.zeros((B, Sb), np.int32)
                        pp = np.full((B, Sb), -1, np.int32)
                        lens = np.ones((B,), np.int32)
                        cow_pairs: List[tuple] = []
                        to_register: List[tuple] = []
                        admitted: List[int] = []
                        for (r, nre), i in zip(take, free):
                            prompt, key, plen, budget = self._unpack_paged(r)
                            pairs, shared = pool.admit(i, prompt, key)
                            cow_pairs += [(s_, d_, i) for s_, d_ in pairs]
                            L = len(prompt)
                            ids[i, :L - shared] = prompt[shared:]
                            pp[i, :L - shared] = np.arange(shared, L)
                            lens[i] = L - shared
                            pos[i] = L
                            slots[i] = {"req": r, "budget": budget,
                                        "out": [], "t0": now,
                                        "restarts": nre,
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
                            ids, pp, pool.pos_map, pool.table, lens, cache)
                        for key, i, toks in to_register:
                            pool.register_prefix(key, i, toks)
                        now = time.monotonic()
                        n_evicted = 0
                        for i in admitted:
                            s = slots[i]
                            t = int(host_first[i])
                            s["out"].append(t)
                            s["hist"].append(t)
                            if (len(s["out"]) >= s["budget"]
                                    or (eos is not None and t == eos)):
                                evict(i, now)
                                n_evicted += 1
                        self.metrics.incr("admitted", len(admitted))
                        self.metrics.incr("batches")
                        if n_evicted:
                            self.metrics.incr("evicted", n_evicted)
                        live = [i for i in range(B) if slots[i] is not None]
                    elif (free and not closing
                          and (carry or q.queue_depth > 0)):
                        # free slots + waiting requests + nothing admitted
                        self.metrics.incr("starved_steps")
                        if self._warm:
                            self.metrics.incr("starved_steps_after_warm")

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
                                            pool.pos_map, pool.table),
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
                            for j in range(a + 1):
                                t = int(host[i, j])
                                s["out"].append(t)
                                s["hist"].append(t)
                                if (len(s["out"]) >= s["budget"]
                                        or (eos is not None and t == eos)):
                                    done = True
                                    break
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
                    # Device failure mid-flight: transient errors restart
                    # the in-flight requests (bounded per request) on a
                    # fresh pool + fresh page accounting; others fail them
                    if self.breaker is not None:
                        self.breaker.record_failure(0)
                    survivors: List[tuple] = []
                    for i in range(B):
                        s = slots[i]
                        slots[i] = None
                        if s is None:
                            continue
                        if is_transient(e) and s["restarts"] < max_restarts:
                            survivors.append((s["req"], s["restarts"] + 1))
                        else:
                            self.metrics.incr("errors")
                            if not s["req"].future.done():
                                s["req"].future.set_exception(e)
                    pos[:] = -1
                    cache = None
                    pool = self._pool = self._new_pool()
                    carry = survivors + carry
                    if survivors:
                        self.metrics.incr("restarts")
        finally:
            self._update_gauges(slots, carry, pool)
            q.consumer_done()

    def _update_gauges(self, slots, carry, pool: PagePool):
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
        ps = pool.stats()
        m.set_gauge("kv_pages_free", ps["kv_pages_free"])
        m.set_gauge("kv_pages_shared", ps["kv_pages_shared"])
        m.set_gauge("kv_pages_leaked", ps["kv_pages_leaked"])
        m.set_counter("cow_copies", ps["cow_copies"])
        m.set_queue_depth(q.queue_depth + len(carry))

    # -- public API ----------------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens: int = 32,
               deadline_ms: Optional[float] = None,
               prefix_key: Optional[str] = None,
               prefix_len: int = 0) -> Future:
        """Async generation; resolves to the ``[<=max_new_tokens]`` int32
        array of greedily decoded tokens (stops after ``eos_token_id``).

        ``prefix_key`` + ``prefix_len`` declare ``prompt_ids[:prefix_len]``
        a shareable prefix (e.g. a system prompt): the first such request
        prefills it once and registers its pages; later requests with the
        same key (and the same leading tokens — verified, divergence falls
        back to a cold admission) map those pages copy-on-write."""
        if max_new_tokens < 1:
            raise InvalidArgumentError("max_new_tokens must be >= 1")
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        return self._batcher.submit(
            (prompt,), deadline_ms=deadline_ms,
            meta=(int(max_new_tokens), prefix_key, int(prefix_len)))

    def generate(self, prompt_ids, max_new_tokens: int = 32,
                 timeout: Optional[float] = None, **kw) -> np.ndarray:
        """Blocking :meth:`submit`."""
        return self.submit(prompt_ids, max_new_tokens, **kw).result(timeout)

    def stats(self) -> dict:
        snap = self.metrics.snapshot()
        snap["buckets"] = len(self._buckets)
        snap["paged"] = True
        snap["quantization"] = self._quantized or "none"
        snap.update(self._pool.stats())
        return snap

    def close(self, drain: bool = True, timeout: Optional[float] = None):
        self._batcher.close(drain=drain, timeout=timeout)
        self._thread.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
