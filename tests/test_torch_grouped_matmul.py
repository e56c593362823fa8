"""``grouped_matmul`` of the port (kernel 10) held against the JAX op.

The plain version ``grouped_matmul_ref`` and the CPU path of the public
op (its ``autograd.Function``: forward, ``dx``, ``dw``) against
``paddle_tpu.ops.grouped_matmul`` run through its Pallas kernel in
interpret mode with explicit ``block_m`` / ``block_n`` and its custom VJP,
at the JAX test's shape (E 3, C 80, D 16, F 160, group sizes [80, 37, 0])
and with group sizes past C and negative.  float32 at rtol / atol 1e-5
(``tests/test_moe.py``'s tolerance); bf16 within one bf16 step: both
round one float32 sum once.  Padding rows are exactly 0, NaN padding
included; ``group_sizes`` gets no gradient; the argument errors are the
JAX op's; the wrapper's choice between the Hopper (wgmma) design and the
first design is a decision table.  On the card (``gpu``), the CUDA kernels
against the plain version at the MoE slice's shapes, the group-size edges
of the 128-row tile and widths off the 8 grid.
"""
import importlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.framework.errors import InvalidArgumentError as JaxArgError
from paddle_tpu.ops.grouped_matmul import grouped_matmul as jax_gmm
from paddle_tpu_torch.framework.errors import InvalidArgumentError
from paddle_tpu_torch.moe import MoELayer
from paddle_tpu_torch.ops.grouped_matmul import (grouped_matmul,
                                                 grouped_matmul_ref)

gmm_mod = importlib.import_module("paddle_tpu_torch.ops.grouped_matmul")
E, C, D, F = 3, 80, 16, 160
BLOCKS = dict(block_m=32, block_n=128)
GROUPS = {"jax_test": [80, 37, 0], "past_c_and_negative": [100, 37, -5],
          "unaligned": [1, 79, 33]}
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       # one bf16 step: 2^-7 of the value, plus a floor for values near 0
       "bfloat16": dict(rtol=2 ** -7, atol=1e-2)}


def _inputs(dtype, seed=11, shape=(E, C, D, F)):
    e, c, d, f = shape
    rng = np.random.RandomState(seed)
    x = rng.randn(e, c, d).astype(np.float32)
    w = rng.randn(e, d, f).astype(np.float32)
    g = rng.randn(e, c, f).astype(np.float32)
    if dtype == "bfloat16":  # values exact in bf16 on both sides
        x, w, g = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                   for a in (x, w, g))
    return x, w, g


def _t(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a)).to(getattr(torch, dtype))


def _j(a, dtype):
    return jnp.asarray(a, getattr(jnp, dtype))


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("groups", list(GROUPS))
def test_forward_and_vjp_match_the_pallas_kernel(dtype, groups):
    x, w, g = _inputs(dtype)
    gs = np.asarray(GROUPS[groups], np.int32)
    jy, vjp = jax.vjp(lambda a, b: jax_gmm(a, b, jnp.asarray(gs), **BLOCKS),
                      _j(x, dtype), _j(w, dtype))
    jdx, jdw = vjp(_j(g, dtype))
    tx = _t(x, dtype).requires_grad_()
    tw = _t(w, dtype).requires_grad_()
    tgs = torch.from_numpy(gs).long()  # torch's own index dtype
    before = grouped_matmul.launches
    ty = grouped_matmul(tx, tw, tgs, **BLOCKS)
    ty.backward(_t(g, dtype))
    assert grouped_matmul.launches == before  # the CPU never launches
    assert ty.dtype == getattr(torch, dtype) and ty.shape == (E, C, F)
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(ty), np.asarray(jy, np.float32), **tol)
    ref = grouped_matmul_ref(_t(x, dtype), _t(w, dtype), tgs)
    assert torch.equal(ref, ty.detach())
    np.testing.assert_allclose(_np(tx.grad), np.asarray(jdx, np.float32),
                               **tol)
    np.testing.assert_allclose(_np(tw.grad), np.asarray(jdw, np.float32),
                               **tol)
    rows = np.arange(C)[None, :] < np.clip(gs, 0, C)[:, None]
    assert not np.any(_np(ty)[~rows]) and not np.any(_np(tx.grad)[~rows])


def test_padding_rows_are_exactly_zero_under_nan():
    x, w, _ = _inputs("float32", seed=3)
    gs = np.asarray([80, 37, 0], np.int32)
    x[1, 37:] = np.nan
    x[2] = np.inf
    jy = np.asarray(jax_gmm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(gs),
                            **BLOCKS))
    for fn in (grouped_matmul, grouped_matmul_ref):
        y = _np(fn(torch.from_numpy(x), torch.from_numpy(w),
                   torch.from_numpy(gs)))
        assert np.all(y[1, 37:] == 0) and np.all(y[2] == 0)
        assert np.all(np.isfinite(y))
        np.testing.assert_allclose(y, jy, rtol=1e-5, atol=1e-5)


def test_group_sizes_get_no_gradient_and_ints_of_any_width_work():
    x, w, g = _inputs("float32", seed=5)
    out = {}
    for dt in (torch.int32, torch.int64, torch.int16):
        tx = torch.from_numpy(x).requires_grad_()
        tw = torch.from_numpy(w).requires_grad_()
        gs = torch.tensor([80, 37, 0], dtype=dt)
        y = grouped_matmul(tx, tw, gs)
        gx, gw = torch.autograd.grad(y, (tx, tw), torch.from_numpy(g))
        out[dt] = (y.detach(), gx, gw)
        assert gs.grad is None and not gs.requires_grad
    for dt in (torch.int64, torch.int16):
        for a, b in zip(out[torch.int32], out[dt]):
            assert torch.equal(a, b)


def test_argument_errors_are_the_jax_ops():
    x, w, _ = _inputs("float32")
    gs = np.asarray([1, 2, 3], np.int32)
    bad = [(x[0], w, gs), (x, w[:2], gs), (x, w[:, :8], gs),
           (x, w, gs[:2]), (x, w, gs.astype(np.float32))]
    for a, b, c in bad:
        with pytest.raises(JaxArgError):
            jax_gmm(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c), **BLOCKS)
        for fn in (grouped_matmul, grouped_matmul_ref):
            with pytest.raises(InvalidArgumentError):
                fn(torch.from_numpy(a), torch.from_numpy(b),
                   torch.from_numpy(c))
    with pytest.raises(InvalidArgumentError, match="integer"):
        grouped_matmul(torch.from_numpy(x), torch.from_numpy(w),
                       torch.ones(3, dtype=torch.bool))


def test_kernel_gate_decision_table():
    """``MoELayer._use_kernel``: JAX's gate with "the activation is on
    CUDA" for "TPU".  The kernel takes any width, so JAX's lane-aligned D
    and F are no condition on the card."""
    def gate(D, F, device):
        cfg = types.SimpleNamespace(hidden_size=D, intermediate_size=F,
                                    moe_experts=1, dropout=0.0)
        xe = types.SimpleNamespace(shape=(1, 4, D),
                                   device=torch.device(device))
        return MoELayer(cfg)._use_kernel(xe)

    assert gate(768, 3072, "cuda") and gate(256, 1024, "cuda")
    assert not gate(768, 3072, "cpu") and not gate(32, 128, "cpu")
    assert gate(32, 128, "cuda") and gate(768, 3000, "cuda")
    assert gate(13, 50, "cuda")


# -- on the card: the CUDA kernel against its plain version ------------------
def _close(y, ref, dtype):
    """f32: |y - ref| <= 1e-5 |ref| + 1e-5 rms(ref); bf16: one bf16 step,
    2^-7 |ref| + 1e-3 rms(ref) — both round one float32 sum once."""
    rel, floor = (1e-5, 1e-5) if dtype == torch.float32 else (2 ** -7, 1e-3)
    yf, rf = y.float(), ref.float()
    rms = float(rf.pow(2).mean().sqrt())
    bad = (yf - rf).abs() > rel * rf.abs() + floor * rms
    assert not bool(bad.any()), float((yf - rf).abs().max())


def _card_case(E_, C_, D_, F_, gs, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(E_, C_, D_, generator=gen).to("cuda", dtype)
    w = (torch.randn(E_, D_, F_, generator=gen) / D_ ** 0.5).to("cuda", dtype)
    return x, w, torch.tensor(gs, device="cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    # the slice's fc1 / fc2 in bf16 (gpt_small, 8 experts, C = 2560)
    (8, 2560, 768, 3072, [2048, 2560, 0, 2600, 1999, 130, -3, 2431],
     "bfloat16"),
    (8, 2560, 3072, 768, [2560, 1, 127, 128, 129, 2559, 0, 3000],
     "bfloat16"),
    # serving (f32): decode C = 16, the verify step C = 80
    (8, 16, 768, 3072, [16, 3, 0, 5, 8, 1, 2, 16], "float32"),
    (8, 80, 3072, 768, [40, 20, 0, 80, 5, 7, 33, 80], "float32"),
    # serving's admission calls (f32): prompt buckets 16 / 48 at batch 8
    # and capacity factor E give C = 256 / 768, past the small-C tile;
    # group sizes as a routing of 128 / 384 rows gives them, and the edges
    (8, 256, 768, 3072, [41, 29, 37, 30, 35, 22, 33, 29], "float32"),
    (8, 256, 3072, 768, [41, 29, 37, 30, 35, 22, 33, 29], "float32"),
    (8, 768, 768, 3072, [101, 88, 120, 79, 95, 102, 91, 92], "float32"),
    (8, 768, 3072, 768, [101, 88, 120, 79, 95, 102, 91, 92], "float32"),
    (8, 256, 768, 3072, [0, 256, 296, -3, 1, 63, 65, 255], "float32"),
    (8, 768, 3072, 768, [0, 768, 808, -3, 1, 63, 65, 767], "float32"),
    # the JAX test's shape, and D not a multiple of 8
    (3, 80, 16, 160, [80, 37, 0], "float32"),
    (3, 80, 16, 160, [80, 37, 0], "bfloat16"),
    (3, 77, 13, 50, [77, 20, 1], "bfloat16"),
    (3, 77, 13, 50, [77, 20, 1], "float32"),
])
def test_kernel_matches_plain_on_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    E_, C_, D_, F_, gs, dt = case
    dtype = getattr(torch, dt)
    x, w, tgs = _card_case(E_, C_, D_, F_, gs, dtype, sum(case[:4]))
    valid = (torch.arange(C_, device="cuda")[None, :]
             < tgs.clamp(0, C_)[:, None])
    x[~valid] = float("nan")  # padding rows of NaN must still give 0
    before = grouped_matmul.launches
    y = grouped_matmul(x, w, tgs)
    y2 = grouped_matmul(x, w, tgs)
    ref = grouped_matmul_ref(x, w, tgs)
    torch.cuda.synchronize()
    assert grouped_matmul.launches == before + 2
    assert torch.equal(y, y2)  # no split-K, no atomics
    assert not bool(y[~valid].any())
    _close(y, ref, dtype)
    with pytest.raises(InvalidArgumentError):
        grouped_matmul(x, w[:, :-1], tgs)


def test_wgmma_decision_table():
    """``_use_wgmma``: the Hopper design or the first design, by dtype, D,
    F and alignment, decided before the launch."""
    bf, f32 = torch.bfloat16, torch.float32
    table = [
        ((bf, 768, 3072, True), True),     # the slice's fc1
        ((bf, 3072, 768, True), True),     # fc2
        ((bf, 16, 160, True), True),       # the JAX test's shape
        ((bf, 8, 8, True), True),
        ((bf, 13, 50, True), False),       # D % 8 != 0
        ((bf, 16, 50, True), False),       # F % 8 != 0
        ((bf, 0, 64, True), False),        # no k: nothing for TMA to load
        ((bf, 768, 3072, False), False),   # unaligned base
        ((f32, 768, 3072, True), False),   # float32 stays SIMT
    ]
    for args, want in table:
        assert gmm_mod._use_wgmma(*args) is want, (args, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dims", [(768, 3072), (3072, 768)],
                         ids=["fc1", "fc2"])
def test_wgmma_group_size_edges_on_card(dims):
    """The slice's shapes through the Hopper design with group sizes 0, 1,
    127, 128, 129 and C (tiles empty, of one row, one short of, exactly at
    and one past the 128-row tile, full); padding rows NaN in, exactly 0
    out; two calls bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    D_, F_ = dims
    gs = [0, 1, 127, 128, 129, 2560, 2047, 640]
    x, w, tgs = _card_case(8, 2560, D_, F_, gs, torch.bfloat16, D_ + 7)
    assert gmm_mod._use_wgmma(x.dtype, D_, F_, True)
    valid = (torch.arange(2560, device="cuda")[None, :]
             < tgs.clamp(0, 2560)[:, None])
    x[~valid] = float("nan")
    y, y2 = grouped_matmul(x, w, tgs), grouped_matmul(x, w, tgs)
    ref = grouped_matmul_ref(x, w, tgs)
    torch.cuda.synchronize()
    assert torch.equal(y, y2)
    assert not bool(y[~valid].any()) and not bool(torch.isnan(y).any())
    _close(y, ref, torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    (3, 77, 13, 50, [77, 20, 1]),     # D and F off the 8 grid
    (3, 80, 16, 50, [80, 37, 0]),     # F off it
    (2, 130, 24, 40, [130, 129]),     # D, F on it, ragged C: wgmma
])
def test_bf16_designs_at_ragged_widths_on_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    E_, C_, D_, F_, gs = case
    x, w, tgs = _card_case(E_, C_, D_, F_, gs, torch.bfloat16, sum(case[:4]))
    valid = (torch.arange(C_, device="cuda")[None, :]
             < tgs.clamp(0, C_)[:, None])
    x[~valid] = float("nan")
    y, y2 = grouped_matmul(x, w, tgs), grouped_matmul(x, w, tgs)
    ref = grouped_matmul_ref(x, w, tgs)
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and not bool(y[~valid].any())
    _close(y, ref, torch.bfloat16)
