"""What the sequence-tagging slice's test files share: a JAX function and
its port run on the same seeded numpy inputs, compared forward (float32
within ``TOL``, index and integer outputs equal in value: the port may
give int64 where JAX gives int32) and backward (autograd against
``jax.grad`` of ``Σ out · c`` for a seeded cotangent ``c``, within 1e-4 of
the JAX gradient's rms).  The JAX side runs under ``jax.jit``: one compile
a case instead of one per eager op.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_RMS = 1e-4


def np_(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    return np.asarray(x)


def leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [v for part in tree for v in leaves(part)]
    return [tree]


def check_out(tout, jout, tol=TOL):
    """Every leaf equal: floats within ``tol``, the rest exactly."""
    tl, jl = leaves(tout), leaves(jout)
    assert len(tl) == len(jl), (len(tl), len(jl))
    for i, (t, j) in enumerate(zip(tl, jl)):
        t, j = np_(t), np.asarray(j)
        assert t.shape == j.shape, (i, t.shape, j.shape)
        if np.issubdtype(j.dtype, np.floating) or j.dtype.name == "bfloat16":
            np.testing.assert_allclose(t, j.astype(np.float32),
                                       err_msg=f"leaf {i}", **tol)
        else:
            np.testing.assert_array_equal(t.astype(np.int64),
                                          j.astype(np.int64),
                                          err_msg=f"leaf {i}")


def check_grads(tgrads, jgrads, names=None):
    """Autograd gradients against JAX's, within 1e-4 of the rms."""
    for i, (g, want) in enumerate(zip(tgrads, jgrads)):
        want = np.asarray(want, np.float64)
        got = np.zeros_like(want) if g is None else np_(g)
        rms = float(np.sqrt(np.mean(want ** 2))) or 1.0
        np.testing.assert_allclose(
            got, want, rtol=GRAD_RMS, atol=GRAD_RMS * rms,
            err_msg=f"d/d {names[i] if names else i}")


def _cot(shape, seed):
    return np.asarray(np.random.RandomState(seed).randn(*shape), np.float32)


def jax_side(jfn, jin, grad=(0,), pick=lambda o: o, seed=1):
    """JAX's output and the gradients of ``Σ pick(out) · c`` (traceable:
    ``jax_references`` runs many cases under one ``jax.jit``)."""
    jout = jfn(*jin)
    if not grad:
        return jout, ()
    cot = _cot(np.shape(pick(jout)), seed)

    def scalar(*gx):
        xs = list(jin)
        for i, v in zip(grad, gx):
            xs[i] = v
        return jnp.sum(pick(jfn(*xs)) * cot)

    jg = jax.grad(scalar, argnums=tuple(range(len(grad))))(
        *[jin[i] for i in grad])
    return jout, jg


def jax_references(cases):
    """``{name: (jfn, arrays, grad, pick, seed)}`` → ``{name: (out,
    grads)}``, every case traced into ONE ``jax.jit`` (one compile for a
    whole parametrised test instead of one a case)."""
    def run(inputs):
        return {n: jax_side(c[0], inputs[n], c[2], c[3], c[4])
                for n, c in cases.items()}

    return jax.jit(run)({n: [jnp.asarray(a) for a in c[1]]
                         for n, c in cases.items()})


def torch_side(tfn, arrays, jout, jgrads, grad=(0,), pick=lambda o: o,
               tol=TOL, seed=1):
    """The port's output and gradients held to JAX's; returns the port's
    output."""
    tin = [torch.tensor(a, requires_grad=i in grad
                        and np.issubdtype(a.dtype, np.floating))
           for i, a in enumerate(arrays)]
    tout = tfn(*tin)
    check_out(tout, jout, tol)
    if not grad:
        return tout
    cot = _cot(np.shape(np.asarray(pick(jout))), seed)
    tg = torch.autograd.grad(
        (pick(tout).float() * torch.from_numpy(cot)).sum(),
        [tin[i] for i in grad], allow_unused=True)
    check_grads(tg, jgrads, names=[f"input {i}" for i in grad])
    return tout


def fwd_bwd(jfn, tfn, arrays, grad=(0,), pick=lambda o: o, tol=TOL,
            seed=1, jit=True):
    """Forward of both on ``arrays`` (compared leaf by leaf), then the
    gradient of ``Σ pick(out) · c`` for the arrays in ``grad``; returns
    the port's output."""
    side = functools.partial(jax_side, jfn, grad=grad, pick=pick, seed=seed)
    if jit:
        side = jax.jit(side)
    jout, jg = side([jnp.asarray(a) for a in arrays])
    return torch_side(tfn, arrays, jout, jg, grad, pick, tol, seed)


@pytest.fixture(autouse=True)
def on_the_cpu():
    """Numpy inputs land on the CPU (the port's default device is the
    card); imported by each test file, it applies to all its tests."""
    from paddle_tpu_torch.framework import device as tdevice

    saved = tdevice._chosen
    tdevice.set_device("cpu")
    yield
    tdevice._chosen = saved
