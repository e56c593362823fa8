"""What the ``test_torch_nn_*`` files share: a JAX layer and its port
from one set of weights (``load_jax_params``), and both held to each
other forward and backward.

``check_pair`` runs both layers on the same numpy inputs and compares
every output leaf; then the gradients of ``Σ leaf · c`` (a seeded
cotangent per floating leaf) with respect to every parameter (the JAX
side through ``paddle_tpu.nn.functional_call`` and ``jax.grad``) and to
the inputs listed in ``grad_inputs``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from paddle_tpu.nn import functional_call
from paddle_tpu_torch.bridge import load_jax_params


def jax_params(layer):
    return {k: np.asarray(p.value) for k, p in layer.named_parameters()}


def jax_buffers(layer):
    return {k: np.asarray(b.value) for k, b in layer.named_buffers()}


def bridged(jl, tl, buffers=False):
    """``tl`` with ``jl``'s parameters (and float buffers), in ``jl``'s
    train / eval mode."""
    load_jax_params(tl, jax_params(jl), jax_buffers(jl) if buffers else None)
    tl.train(jl.training)
    return tl


def leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [x for part in tree for x in leaves(part)]
    return [tree]


def _floats(values):
    return [v for v in values if jnp.issubdtype(v.dtype, jnp.floating)]


def check_pair(jl, tl, inputs, rtol=1e-5, atol=1e-5, grad_inputs=(0,),
               kwargs=None, params=True, seed=1):
    """Forward and gradients of ``jl`` and its bridged port ``tl`` on
    ``inputs`` (numpy); returns the port's outputs."""
    kwargs = kwargs or {}
    tol = dict(rtol=rtol, atol=atol)
    jin = [jnp.asarray(a) for a in inputs]
    tin = [torch.tensor(a, requires_grad=i in grad_inputs)
           for i, a in enumerate(inputs)]
    jout = leaves(jl(*jin, **kwargs))
    tout = leaves(tl(*tin, **kwargs))
    assert len(jout) == len(tout)
    for j, t in zip(jout, tout):
        np.testing.assert_allclose(t.detach().float().numpy(),
                                   np.asarray(j, np.float32), **tol)
    rng = np.random.RandomState(seed)
    cots = [np.asarray(rng.randn(*np.shape(j)), np.float32)
            for j in _floats(jout)]
    if not cots:
        return tout
    names = [n for n, p in tl.named_parameters() if p.requires_grad] \
        if params else []
    jp = jax_params(jl)

    def jloss(p, *xs):
        args = list(jin)
        for i, x in zip(grad_inputs, xs):
            args[i] = x
        full = dict(jp)
        full.update(p)
        outs = _floats(leaves(functional_call(jl, full, *args, **kwargs)))
        return sum(jnp.sum(o * c) for o, c in zip(outs, cots))

    jg = jax.grad(jloss, argnums=tuple(range(1 + len(grad_inputs))))(
        {n: jnp.asarray(jp[n]) for n in names},
        *[jin[i] for i in grad_inputs])
    tparams = dict(tl.named_parameters())
    touts = [t for t in tout if t.is_floating_point()]
    tg = torch.autograd.grad(
        sum((t.float() * torch.from_numpy(c)).sum()
            for t, c in zip(touts, cots)),
        [tparams[n] for n in names] + [tin[i] for i in grad_inputs],
        allow_unused=True)
    for n, g in zip(names, tg):
        want = np.asarray(jg[0][n])
        got = np.zeros_like(want) if g is None else g.numpy()
        np.testing.assert_allclose(got, want, err_msg=f"d/d {n}", **tol)
    for i, g, want in zip(grad_inputs, tg[len(names):], jg[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(want),
                                   err_msg=f"d/d input {i}", **tol)
    return tout
