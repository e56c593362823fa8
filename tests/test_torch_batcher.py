"""The worker mode of the port's ``MicroBatcher`` (the legacy generation
scheduler runs under it): the cases of tests/test_serving.py's
``TestMicroBatcher`` — same-bucket grouping, the delay flushing a partial
batch, deadline expiry of a queued request, load shedding, a runner
exception failing only its batch, graceful drain — plus the circuit
breaker's shedding, the transient retry and the drain timeout.
"""
import threading
import time

import numpy as np
import pytest

from paddle_tpu_torch.framework.errors import (ExecutionTimeoutError,
                                               TransientDeviceError,
                                               UnavailableError)
from paddle_tpu_torch.resilience import CircuitBreaker, RetryPolicy
from paddle_tpu_torch.serving import MicroBatcher


def _echo_batcher(**kw):
    # router: bucket by first-input length; runner: echo the batch size
    return MicroBatcher(
        lambda ins: len(ins[0]),
        lambda bucket, reqs: [(bucket, len(reqs))] * len(reqs), **kw)


def test_groups_same_bucket():
    with _echo_batcher(max_batch_size=4, max_queue_delay_ms=60.0) as mb:
        futs = [mb.submit(([0, 0],)) for _ in range(4)]
        assert {f.result(10) for f in futs} == {(2, 4)}
        snap = mb.metrics.snapshot()
    assert snap["batches"] == 1 and snap["completed"] == 4
    assert snap["batch_occupancy"] == 1.0


def test_delay_flushes_partial_batch():
    with _echo_batcher(max_batch_size=64, max_queue_delay_ms=10.0) as mb:
        assert mb.submit(([0],)).result(10) == (1, 1)


def test_capacity_bounds_each_bucket():
    mb = MicroBatcher(lambda ins: len(ins[0]),
                      lambda bucket, reqs: [len(reqs)] * len(reqs),
                      max_batch_size=8, max_queue_delay_ms=50.0,
                      capacity=lambda bucket: 2)
    try:
        futs = [mb.submit(([0],)) for _ in range(4)]
        assert [f.result(10) for f in futs] == [2, 2, 2, 2]
    finally:
        mb.close()


def test_deadline_expires_queued_request():
    release = threading.Event()

    def slow_runner(bucket, reqs):
        release.wait(10)
        return [None] * len(reqs)

    mb = MicroBatcher(lambda ins: 0, slow_runner, max_batch_size=1,
                      max_queue_delay_ms=0.0)
    try:
        blocker = mb.submit((np.zeros(1),))        # occupies the worker
        doomed = mb.submit((np.zeros(1),), deadline_ms=1.0)
        time.sleep(0.05)
        release.set()
        blocker.result(10)
        with pytest.raises(ExecutionTimeoutError):
            doomed.result(10)
        assert mb.metrics.snapshot()["expired"] == 1
    finally:
        release.set()
        mb.close()


def test_load_shedding():
    started, release = threading.Event(), threading.Event()

    def slow_runner(bucket, reqs):
        started.set()
        release.wait(10)
        return [None] * len(reqs)

    mb = MicroBatcher(lambda ins: 0, slow_runner, max_batch_size=1,
                      max_queue_delay_ms=0.0, max_queue_depth=2)
    try:
        futs = [mb.submit((np.zeros(1),))]
        assert started.wait(10)  # the worker is busy now
        futs += [mb.submit((np.zeros(1),)) for _ in range(2)]
        with pytest.raises(UnavailableError):  # depth at the limit
            mb.submit((np.zeros(1),))
        assert mb.metrics.snapshot()["shed"] >= 1
        release.set()
        for f in futs:
            f.result(10)
    finally:
        release.set()
        mb.close()


def test_runner_exception_fails_batch_not_worker():
    def runner(bucket, reqs):
        if bucket == 13:
            raise RuntimeError("boom")
        return [bucket] * len(reqs)

    with MicroBatcher(lambda ins: len(ins[0]), runner, max_batch_size=1,
                      max_queue_delay_ms=0.0) as mb:
        with pytest.raises(RuntimeError):
            mb.submit(([0] * 13,)).result(10)
        assert mb.submit(([0],)).result(10) == 1  # still alive
        assert mb.metrics.snapshot()["errors"] == 1


def test_wrong_result_count_fails_the_batch():
    with MicroBatcher(lambda ins: 0, lambda b, reqs: [], max_batch_size=1,
                      max_queue_delay_ms=0.0) as mb:
        with pytest.raises(UnavailableError, match="results"):
            mb.submit((np.zeros(1),)).result(10)


def test_graceful_drain_and_closed_submit():
    mb = _echo_batcher(max_batch_size=2, max_queue_delay_ms=1.0)
    futs = [mb.submit(([0],)) for _ in range(5)]
    mb.close(drain=True, timeout=10)
    for f in futs:
        assert f.result(0) is not None  # all served before the join
    with pytest.raises(UnavailableError):
        mb.submit(([0],))


def test_close_without_drain_fails_queued():
    release = threading.Event()

    def slow_runner(bucket, reqs):
        release.wait(10)
        return [None] * len(reqs)

    mb = MicroBatcher(lambda ins: 0, slow_runner, max_batch_size=1,
                      max_queue_delay_ms=0.0)
    first = mb.submit((np.zeros(1),))
    time.sleep(0.02)
    rest = [mb.submit((np.zeros(1),)) for _ in range(3)]
    threading.Timer(0.1, release.set).start()
    mb.close(drain=False, timeout=10)
    assert first.result(10) is None
    for f in rest:
        assert isinstance(f.exception(timeout=10), UnavailableError)


def test_drain_timeout_fails_the_stranded():
    release = threading.Event()

    def stuck(bucket, reqs):
        release.wait(10)
        return [None] * len(reqs)

    mb = MicroBatcher(lambda ins: 0, stuck, max_batch_size=1,
                      max_queue_delay_ms=0.0)
    try:
        mb.submit((np.zeros(1),))
        time.sleep(0.02)
        queued = mb.submit((np.zeros(1),))
        mb.close(drain=True, timeout=0.1)
        assert isinstance(queued.exception(timeout=1), UnavailableError)
        assert mb.metrics.snapshot()["drain_timeout"] == 1
    finally:
        release.set()


def test_open_circuit_sheds_its_bucket():
    breaker = CircuitBreaker("pt-mb", failure_threshold=0.5, window=2,
                             cooldown_ms=60_000)

    def runner(bucket, reqs):
        if bucket == 2:
            raise RuntimeError("bad bucket")
        return [bucket] * len(reqs)

    with MicroBatcher(lambda ins: len(ins[0]), runner, max_batch_size=1,
                      max_queue_delay_ms=0.0, breaker=breaker) as mb:
        for _ in range(2):
            with pytest.raises(RuntimeError):
                mb.submit(([0, 0],)).result(10)
        with pytest.raises(UnavailableError, match="circuit open"):
            mb.submit(([0, 0],)).result(10)
        assert mb.submit(([0],)).result(10) == 1  # other buckets serve
        assert mb.metrics.snapshot()["circuit_shed"] == 1


def test_transient_failure_is_retried():
    calls = []

    def flaky(bucket, reqs):
        calls.append(len(reqs))
        if len(calls) == 1:
            raise TransientDeviceError("hiccup")
        return ["ok"] * len(reqs)

    retry = RetryPolicy(max_attempts=3, backoff_ms=1.0, sleep=lambda s: None)
    with MicroBatcher(lambda ins: 0, flaky, max_batch_size=1,
                      max_queue_delay_ms=0.0, retry=retry) as mb:
        assert mb.submit((np.zeros(1),), deadline_ms=5_000).result(10) == "ok"
    assert len(calls) == 2


def test_worker_mode_needs_a_runner():
    with pytest.raises(UnavailableError):
        MicroBatcher(lambda ins: 0, None, pull=False)
