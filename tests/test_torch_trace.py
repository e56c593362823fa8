"""The port's request traces (paddle_tpu_torch/tuning/trace.py, a copy of
the JAX package's host-only module).

``RequestTrace.synthetic()`` — bench.py's serving workload — must be the
JAX package's, entry for entry and bit for bit, with the same ``key()``;
``save`` / ``load`` round-trip in both directions; ``TraceRecorder``
records what passes through ``submit``; ``replay`` drives a port engine
and returns the JAX function's keys.
"""
import numpy as np
import pytest
import torch

from paddle_tpu.tuning import RequestTrace as JaxRequestTrace
from paddle_tpu.tuning import TraceRecorder as JaxTraceRecorder
from paddle_tpu_torch import tuning
from paddle_tpu_torch.framework.errors import InvalidArgumentError
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_tiny
from paddle_tpu_torch.serving import GenerationEngine
from paddle_tpu_torch.tuning import RequestTrace, TraceRecorder, replay


def _same(a, b):
    assert len(a) == len(b) and a.name == b.name and a.seed == b.seed
    for (p, n), (q, m) in zip(a, b):
        assert p.dtype == q.dtype == np.int32 and n == m
        np.testing.assert_array_equal(p, q)


@pytest.mark.parametrize("kw", [{}, dict(n=7, seed=3, vocab=97,
                                         prompt_range=(2, 9),
                                         new_range=(1, 5))])
def test_synthetic_is_the_jax_trace(kw):
    t, j = RequestTrace.synthetic(**kw), JaxRequestTrace.synthetic(**kw)
    _same(t, j)
    assert t.key() == j.key()
    assert t.total_new_tokens == j.total_new_tokens


def test_bench_workload_shape():
    t = RequestTrace.synthetic()
    assert len(t) == 48 and t.name == "synthetic-s17-n48"
    lens = [len(p) for p, _ in t]
    assert min(lens) >= 4 and max(lens) <= 48
    assert all(4 <= n <= 64 for _, n in t)


def test_save_load_both_ways(tmp_path):
    t = RequestTrace.synthetic(n=5)
    t.save(str(tmp_path / "port.json"))
    _same(JaxRequestTrace.load(str(tmp_path / "port.json")), t)
    JaxRequestTrace.synthetic(n=5).save(str(tmp_path / "jax.json"))
    back = RequestTrace.load(str(tmp_path / "jax.json"))
    _same(back, t)
    assert back.key() == t.key()
    (tmp_path / "bad.json").write_text("[1, 2]")
    with pytest.raises(InvalidArgumentError):
        RequestTrace.load(str(tmp_path / "bad.json"))


def test_recorder_wraps_submit_like_jax():
    calls = []
    rec, jrec = TraceRecorder(name="r", limit=2), JaxTraceRecorder(
        name="r", limit=2)
    for r in (rec, jrec):
        sub = r.wrap(lambda p, n, *a, **k: calls.append((list(p), n)))
        for i in range(3):
            sub(np.arange(i + 1), i + 2, deadline_ms=5.0)
    assert len(calls) == 6 and len(rec) == len(jrec) == 2
    _same(rec.trace(), jrec.trace())


def test_replay_drives_an_engine():
    torch.set_num_threads(2)
    model = GPTForCausalLM(gpt_tiny(vocab_size=97), device="cpu",
                           generator=torch.Generator().manual_seed(1))
    trace = RequestTrace.synthetic(n=6, vocab=97, prompt_range=(2, 9),
                                   new_range=(1, 6))
    with GenerationEngine(model, prompt_buckets=[8], batch_size=2,
                          name="pt-replay") as eng:
        out = replay(eng, trace)
    assert set(out) == {"tokens", "seconds", "tokens_per_sec", "mean_ms",
                        "p50_ms", "p99_ms", "requests"}
    assert out["tokens"] == trace.total_new_tokens
    assert out["requests"] == 6 and out["tokens_per_sec"] > 0


def test_package_exports_the_three_names():
    assert tuning.__all__ == ["RequestTrace", "TraceRecorder", "replay"]
