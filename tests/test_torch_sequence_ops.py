"""The port's dense sequence ops (``paddle_tpu_torch.nn.functional
.sequence``) against the JAX package's, forward and ``jax.grad``, on
seeded numpy batches with ragged lengths (0, 1 and full rows), and the
argument errors both packages raise.

Float outputs within rtol / atol 1e-5, integer outputs equal in value,
gradients within 1e-4 of the JAX gradient's rms (``torch_op_pairs``).
"""
import numpy as np
import pytest

from paddle_tpu.framework.errors import InvalidArgumentError as JErr
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch.framework.errors import InvalidArgumentError as TErr
from paddle_tpu_torch.nn import functional as TF
from torch_op_pairs import check_out, fwd_bwd, on_the_cpu  # noqa: F401

B, T, D = 4, 6, 3
LENGTHS = np.array([6, 1, 0, 4], np.int64)


def _x(seed=0, *shape):
    return np.random.RandomState(seed).randn(
        *(shape or (B, T, D))).astype(np.float32)


def _call(fn, *args, **kw):
    return lambda *xs: fn(*xs, *args, **kw)


POOLS = ["sum", "average", "sqrt", "max", "first", "last"]


@pytest.mark.parametrize("pool", POOLS)
@pytest.mark.parametrize("lengths", ["ragged", "full"])
def test_sequence_pool_matches_jax(pool, lengths):
    ln = LENGTHS if lengths == "ragged" else None
    jfn = lambda x: JF.sequence_pool(x, pool, pad_value=-7.0, lengths=ln)
    tfn = lambda x: TF.sequence_pool(x, pool, pad_value=-7.0, lengths=ln)
    fwd_bwd(jfn, tfn, [_x(1)], grad=(0,))


OPS = {
    "first_step": (lambda F, ln: lambda x: F.sequence_first_step(x, ln),
                   True),
    "last_step": (lambda F, ln: lambda x: F.sequence_last_step(x, ln),
                  True),
    "softmax": (lambda F, ln: lambda x: F.sequence_softmax(
        x[..., 0], lengths=ln), True),
    "reverse": (lambda F, ln: lambda x: F.sequence_reverse(x, lengths=ln),
                True),
    "unpad": (lambda F, ln: lambda x: F.sequence_unpad(x, ln), True),
    "pad_extend": (lambda F, ln: lambda x: F.sequence_pad(
        x, -1.0, maxlen=T + 2, lengths=ln), True),
    "pad_trim": (lambda F, ln: lambda x: F.sequence_pad(
        x, 0.5, maxlen=3, lengths=ln), True),
    "expand_as": (lambda F, ln: lambda x: F.sequence_expand_as(
        x[:, 0], x), True),
    "enumerate": (lambda F, ln: lambda x: F.sequence_enumerate(
        x, 3, pad_value=-1, lengths=ln), False),
    "slice": (lambda F, ln: lambda x: F.sequence_slice(
        x, np.array([0, 2, 1, 3]), 3), True),
    "reshape": (lambda F, ln: lambda x: F.sequence_reshape(
        x, 6, lengths=np.array([6, 2, 0, 4])), True),
    "scatter": (lambda F, ln: lambda x: F.sequence_scatter(
        x, np.array([[0, 2, 2], [1, 5, 0], [3, 3, 3], [5, 4, 0]]),
        x[:, :3] * 2.0, lengths=np.array([3, 1, 0, 2])), True),
    "concat": (lambda F, ln: lambda x: F.sequence_concat(
        [x, x[:, :4] + 1.0], lengths=[ln, np.array([2, 4, 1, 0])]), True),
    "concat_full": (lambda F, ln: lambda x: F.sequence_concat(
        [x, x[:, :2]]), True),
}


@pytest.mark.parametrize("name", sorted(OPS))
def test_sequence_op_matches_jax(name):
    make, floating = OPS[name]
    if floating:
        fwd_bwd(make(JF, LENGTHS), make(TF, LENGTHS), [_x(2)], grad=(0,),
                pick=lambda o: o[0] if isinstance(o, tuple) else o)
    else:
        ids = np.random.RandomState(3).randint(1, 9, (B, T)).astype(np.int64)
        fwd_bwd(make(JF, LENGTHS), make(TF, LENGTHS), [ids], grad=())


def test_sequence_expand_is_eager_with_max_length_rows():
    x = _x(4, B, D)
    ln = np.array([2, 3, 1, 3], np.int64)
    fwd_bwd(lambda a: JF.sequence_expand(a, ln),
            lambda a: TF.sequence_expand(a, ln), [x], grad=(0,), jit=False)


def test_sequence_enumerate_reference_docstring_case():
    """sequence_lod.py:1246: windows of 2 over [1, 2, 3] padded with 0."""
    x = np.array([[1, 2, 3, 0]], np.int64)
    got = TF.sequence_enumerate(x, 2, pad_value=0, lengths=np.array([3]))
    check_out(got, JF.sequence_enumerate(x, 2, pad_value=0,
                                         lengths=np.array([3])))
    assert got.tolist() == [[[1, 2], [2, 3], [3, 0], [0, 0]]]


ERRORS = {
    "pool_type": lambda F, x: F.sequence_pool(x, "median"),
    "slice_window": lambda F, x: F.sequence_slice(x, [5, 0, 0, 0], 2),
    "slice_lengths": lambda F, x: F.sequence_slice(
        x, [0, 0, 0, 0], np.array([1, 2])),
    "reshape_width": lambda F, x: F.sequence_reshape(x, 7),
    "reshape_rows": lambda F, x: F.sequence_reshape(
        x, 6, lengths=np.array([3, 1, 1, 1])),
}


@pytest.mark.parametrize("name", sorted(ERRORS))
def test_argument_errors_raise_in_both(name):
    x = _x(5)
    with pytest.raises(JErr):
        ERRORS[name](JF, x)
    with pytest.raises(TErr):
        ERRORS[name](TF, x)
