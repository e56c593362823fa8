"""The port's copies of the host-side pieces the serving path uses —
flags, error classification, circuit breaker, retry policy, fault plans —
held against the JAX package's originals on the same inputs."""
import numpy as np
import pytest

from paddle_tpu.framework import errors as jax_errors
from paddle_tpu.framework.flags import flag as jax_flag
from paddle_tpu.resilience.circuit import CircuitBreaker as JaxBreaker
from paddle_tpu.resilience.faults import FaultPlan as JaxFaultPlan
from paddle_tpu.resilience.retry import RetryPolicy as JaxRetryPolicy
from paddle_tpu_torch.framework import errors
from paddle_tpu_torch.framework.flags import _REGISTRY, flag, set_flags
from paddle_tpu_torch.resilience.circuit import CircuitBreaker
from paddle_tpu_torch.resilience.faults import FaultPlan, fault_point
from paddle_tpu_torch.resilience.retry import RetryPolicy


def test_flag_defaults_match_jax():
    for name in _REGISTRY:
        assert flag(name) == jax_flag(name), name
    with pytest.raises(errors.NotFoundError):
        set_flags({"paged_flash": True})  # not carried: the kernel always runs


@pytest.mark.parametrize("exc", [
    errors.TransientDeviceError("x"), errors.UnavailableError("x"),
    errors.InvalidArgumentError("resource exhausted"),
    RuntimeError("CUDA error: resource exhausted"), RuntimeError("boom"),
    OSError("connection reset by peer"), ValueError("unavailable")])
def test_is_transient_matches_jax(exc):
    twin = exc
    if isinstance(exc, errors.EnforceNotMet):
        twin = getattr(jax_errors, type(exc).__name__)(str(exc))
    assert errors.is_transient(exc) == jax_errors.is_transient(twin)


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_circuit_breaker_state_machine_matches_jax():
    rng = np.random.RandomState(0)
    clocks = [_Clock(), _Clock()]
    kw = dict(failure_threshold=0.5, window=4, cooldown_ms=100.0,
              half_open_probes=2)
    pair = [CircuitBreaker("p", clock=clocks[0], **kw),
            JaxBreaker("j", clock=clocks[1], **kw)]
    for _ in range(400):
        op, dt = rng.randint(3), float(rng.rand() * 0.05)
        seen = []
        for br, ck in zip(pair, clocks):
            ck.t += dt
            if op == 0:
                seen.append(br.allow(0))
            elif op == 1:
                br.record_success(0)
            else:
                br.record_failure(0)
            seen.append(br.state(0))
        assert seen[: len(seen) // 2] == seen[len(seen) // 2:]
    s0, s1 = pair[0].stats(), pair[1].stats()
    for k in ("opens", "sheds", "failures", "successes", "open_keys"):
        assert s0[k] == s1[k], k
    assert s0["opens"] > 0


def test_retry_policy_backoff_matches_jax_and_gives_up():
    a = RetryPolicy(max_attempts=4, backoff_ms=10, seed=3)
    b = JaxRetryPolicy(max_attempts=4, backoff_ms=10, seed=3)
    assert [a.delay_s(i) for i in range(5)] == [b.delay_s(i)
                                                for i in range(5)]
    slept, calls = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise errors.TransientDeviceError("blip")
        return "ok"

    assert RetryPolicy(max_attempts=3, sleep=slept.append).call(flaky) == "ok"
    assert len(slept) == 2
    with pytest.raises(errors.InvalidArgumentError):  # never retried
        RetryPolicy(sleep=slept.append).call(
            lambda: (_ for _ in ()).throw(errors.InvalidArgumentError("x")))
    assert len(slept) == 2


@pytest.mark.parametrize("spec", [
    "site=s,nth=3", "site=s,every=2,times=3", "site=s,p=0.3,seed=5",
    "site=s,every=4;site=t,nth=1"])
def test_fault_plan_firing_matches_jax(spec):
    fired = []
    for cls in (FaultPlan, JaxFaultPlan):
        plan, pattern = cls.parse(spec), []
        for _ in range(20):
            for site in ("s", "t"):
                try:
                    plan._hit(site)
                    pattern.append(0)
                except Exception as e:  # the injected TransientDeviceError
                    assert type(e).__name__ == "TransientDeviceError"
                    pattern.append(1)
        fired.append(pattern)
    assert fired[0] == fired[1] and sum(fired[0]) > 0


def test_fault_point_is_inert_without_a_plan():
    fault_point("serving.decode")  # no plan installed: no-op
    with FaultPlan.parse("site=serving.decode,nth=1"):
        with pytest.raises(errors.TransientDeviceError):
            fault_point("serving.decode")
    fault_point("serving.decode")
    with pytest.raises(errors.InvalidArgumentError):
        FaultPlan.parse("site=s")  # needs exactly one trigger
