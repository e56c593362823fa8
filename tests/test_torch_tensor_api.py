"""The port's tensor API (``paddle_tpu_torch.tensor``, re-exported at the
top level) held against the JAX package's ``paddle_tpu.tensor``: one case
per exported name (``tools/torch_tensor_cases.py`` holds the calls and the
tolerance of each: exact, float32 elementwise rtol 1e-5 / atol 1e-6,
special functions 1e-5 / 1e-5, factorizations 1e-4 / 1e-5 in sign-free
forms).  Integer results may be int64 where JAX (x64 off) gives int32.
The random functions are held to shapes, dtypes, seeding and moments
(torch's generator is not JAX's).  On the CPU: the default device is set
to the CPU for each test."""
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu.tensor as jt
import paddle_tpu_torch as tpt
import paddle_tpu_torch.tensor as tt
from paddle_tpu_torch.framework import device as tdevice
from paddle_tpu_torch.framework.dtype import numpy_to_tensor, to_numpy

_spec = importlib.util.spec_from_file_location(
    "torch_tensor_cases", pathlib.Path(__file__).resolve().parents[1]
    / "tools" / "torch_tensor_cases.py")
cases = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cases)

EXPORTED = sorted(n for n in dir(jt) if not n.startswith("_"))


@pytest.fixture(autouse=True)
def _cpu_default():
    saved = tdevice._chosen
    tdevice.set_device("cpu")
    yield
    tdevice._chosen = saved


def _run_jax(name, args, kwargs):
    out = getattr(jt, name)(*cases.convert(args, jnp.asarray),
                            **cases.convert(kwargs, jnp.asarray))
    return cases.to_host(out, np.asarray)


def _run_port(name, args, kwargs, device="cpu"):
    def to(a):
        return numpy_to_tensor(a, device)
    out = getattr(tt, name)(*cases.convert(args, to),
                            **cases.convert(kwargs, to))
    return out, cases.to_host(out, to_numpy)


def test_every_exported_name_has_a_case():
    table = set(cases.CASES) | set(cases.RANDOM) | set(cases.MODULES)
    assert table == set(EXPORTED), (set(EXPORTED) - table,
                                    table - set(EXPORTED))
    assert len(EXPORTED) == 308


@pytest.mark.parametrize("name", EXPORTED)
def test_name_matches_jax(name):
    """The port's top level exports the name too (as the JAX package's
    does), and the call matches JAX's."""
    assert getattr(tpt, name) is getattr(tt, name)
    if name in cases.MODULES:
        jmod, tmod = getattr(jt, name), getattr(tt, name)
        assert set(tmod.__all__) == set(jmod.__all__), name
        return
    if name in cases.RANDOM:
        _check_random(name)
        return
    make, kind = cases.CASES[name]
    args, kwargs = make(np.random.RandomState(0))
    want = _run_jax(name, args, kwargs)
    out, got = _run_port(name, args, kwargs)
    cases.compare(kind, got, want)
    for leaf in (out if isinstance(out, (list, tuple)) else [out]):
        if isinstance(leaf, torch.Tensor):
            assert leaf.device.type == "cpu"


def _check_random(name):
    args, kwargs = cases.RANDOM[name](np.random.RandomState(0))
    tpt.seed(123)
    _, a = _run_port(name, args, kwargs)
    tpt.seed(123)
    _, b = _run_port(name, args, kwargs)
    np.testing.assert_array_equal(a, b)
    jpt.seed(123)
    if name == "poisson":
        # JAX's poisson runs on the threefry RNG only, and the package
        # uses rbg: its result is the input's shape and dtype
        j = np.zeros_like(args[0])
    else:
        j = _run_jax(name, args, kwargs)
    a, j = np.asarray(a), np.asarray(j)
    assert a.shape == j.shape, (a.shape, j.shape)
    assert a.dtype.kind == j.dtype.kind or {a.dtype.kind, j.dtype.kind} <= {
        "i", "u"}, (a.dtype, j.dtype)
    mean, std = cases.MOMENTS[name]
    n = a.size
    spread = std if std is not None else float(np.std(a)) or 1.0
    assert abs(float(a.mean()) - mean) < 5 * spread / np.sqrt(n), (
        name, a.mean(), mean)
    if std is not None:
        assert abs(float(a.std()) - std) < 0.1 * std, (name, a.std(), std)
    if name == "randperm":
        assert sorted(a.tolist()) == list(range(50))
    if name in ("uniform", "rand", "uniform_"):
        lo, hi = (-2.0, 2.0) if name == "uniform" else (0.0, 1.0)
        assert a.min() >= lo and a.max() < hi


@pytest.mark.parametrize("name,args,want", [
    ("split", (np.arange(12.0).reshape(6, 2), 3), [2, 2, 2]),
    ("split", (np.arange(12.0).reshape(6, 2), [1, -1, 2]), [1, 3, 2]),
    ("chunk", (np.arange(14.0).reshape(7, 2), 3), [3, 2, 2])],
    ids=["split_sections", "split_minus_one", "chunk_array_split"])
def test_split_counts_sections_not_chunk_sizes(name, args, want):
    """``split(x, 3)`` is 3 sections (``torch.split(x, 3)`` would give
    chunks of 3 rows); ``chunk`` splits as ``array_split``."""
    parts = getattr(tpt, name)(torch.from_numpy(args[0]).float(), args[1])
    assert [p.shape[0] for p in parts] == want


def test_median_averages_and_mod_takes_the_divisors_sign():
    x = torch.tensor([1.0, 4.0, 2.0, 3.0])
    assert float(tpt.median(x)) == 2.5 and float(torch.median(x)) == 2.0
    assert float(tpt.median(x, mode="min")) == 2.0
    r = tpt.mod(torch.tensor([-7, 7]), torch.tensor([3, -3]))
    assert r.tolist() == [2, -2]  # jnp.mod; torch.fmod gives [-1, 1]
    assert tpt.divide(torch.tensor([7]), torch.tensor([2])).tolist() == [3.5]


def test_creation_lands_on_the_default_device_and_raises_without_a_card():
    assert tpt.zeros([2]).device.type == "cpu"   # set_device("cpu")
    tdevice._chosen = None                       # the default: the card
    if not torch.cuda.is_available():
        from paddle_tpu_torch.framework.errors import UnavailableError
        with pytest.raises(UnavailableError):
            tpt.zeros([2])
