"""Global flag registry (port of ``paddle_tpu.framework.flags``).

Typed in-process registry; environment variables named ``FLAGS_<name>``
seed the initial value, as in the reference's gflags
(paddle/fluid/platform/flags.cc, python/paddle/fluid/framework.py
``set_flags``).  Only the flags the ported serving path reads are
registered here.
"""
from __future__ import annotations

import os
from typing import Any, Dict

from .errors import InvalidArgumentError, NotFoundError

__all__ = ["define_flag", "set_flags", "get_flags", "flag"]

_REGISTRY: Dict[str, dict] = {}


def _parse_bool(s: str) -> bool:
    return s.lower() in ("1", "true", "yes", "on")


def define_flag(name: str, default: Any, help_str: str = "",
                type_: type | None = None):
    """Register a flag. Env var FLAGS_<name> overrides the default."""
    t = type_ or type(default)
    value = default
    env = os.environ.get(f"FLAGS_{name}")
    if env is not None:
        value = _parse_bool(env) if t is bool else t(env)
    _REGISTRY[name] = {"value": value, "default": default, "type": t,
                       "help": help_str}
    return value


def set_flags(flags: Dict[str, Any]):
    """Parity: ``paddle.set_flags``."""
    for name, value in flags.items():
        if name not in _REGISTRY:
            raise NotFoundError(f"Unknown flag {name!r}")
        t = _REGISTRY[name]["type"]
        if t is bool and isinstance(value, str):
            value = _parse_bool(value)
        try:
            _REGISTRY[name]["value"] = t(value)
        except (TypeError, ValueError) as e:
            raise InvalidArgumentError(
                f"Bad value for flag {name}: {value!r}") from e


def get_flags(names) -> Dict[str, Any]:
    """Parity: ``paddle.get_flags``."""
    if isinstance(names, str):
        names = [names]
    out = {}
    for name in names:
        if name not in _REGISTRY:
            raise NotFoundError(f"Unknown flag {name!r}")
        out[name] = _REGISTRY[name]["value"]
    return out


def flag(name: str) -> Any:
    """Fast single-flag read for internal use."""
    return _REGISTRY[name]["value"]


define_flag("transient_max_retries", 3,
            "Max attempts (1 = no retry) for operations retried on "
            "transient device errors (errors.is_transient); the paged "
            "decode loop restarts in-flight requests up to this many "
            "times minus one. See resilience.RetryPolicy.")
define_flag("retry_backoff_ms", 100.0,
            "Base delay of the exponential backoff between transient-"
            "error retries (doubles per attempt, +/-25% seeded jitter, "
            "capped at 20x the base).")
define_flag("circuit_failure_threshold", 0.5,
            "Serving circuit breaker (resilience/circuit.py): open a "
            "key's circuit when its failure rate over the last "
            "FLAGS_circuit_window outcomes reaches this fraction.")
define_flag("circuit_window", 8,
            "Number of most-recent outcomes per key the circuit breaker "
            "evaluates the failure rate over (it never opens before "
            "observing a full window).")
define_flag("circuit_cooldown_ms", 1000.0,
            "How long an open circuit sheds before letting half-open "
            "probes through to test recovery.")
define_flag("circuit_half_open_probes", 1,
            "Probes admitted in the half-open state; all must succeed to "
            "close the circuit, any failure re-opens it.")
define_flag("continuous_batching", True,
            "GenerationEngine decode scheduling: on (default), requests "
            "are admitted into and evicted from individual decode slots "
            "at decode-step granularity. Per-engine override: "
            "GenerationEngine(continuous=...).")
define_flag("paged_kv", False,
            "GenerationEngine KV-cache layout: on, the decode loop stores "
            "KV in fixed-size pages behind a slot->page-table indirection "
            "(vLLM-style PagedAttention), shared copy-on-write across "
            "slots with a common prefix; off (default), one dense ring "
            "KV cache of batch_size x cache_len slots. Per-engine "
            "override: GenerationEngine(paged=...).")
define_flag("kv_page_size", 16,
            "Tokens per KV page in paged mode; must divide the engine's "
            "max_len.")
define_flag("speculative_k", 4,
            "Speculative decoding draft length in paged mode: an n-gram "
            "proposer (prompt-lookup) drafts up to k tokens per slot and "
            "one batched verify step accepts the longest matching prefix "
            "— token-identical to plain greedy. 0 disables speculation.")
define_flag("executor_cache_capacity", 64,
            "LRU capacity of each static.Executor's runner cache. Every "
            "distinct (program, feed signature, fetch set) of run_steps "
            "holds its captured CUDA graphs; unbounded growth is a slow "
            "leak, a too-small cap captures again on every run.")
define_flag("paddle_num_threads", 1,
            "Host-side worker threads for data feeding: the default "
            "thread count of InMemoryDataset.load_into_memory "
            "(ref: FLAGS_paddle_num_threads).")
