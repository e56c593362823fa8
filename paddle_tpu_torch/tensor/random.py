"""Random sampling — port of ``paddle_tpu.tensor.random``.

Every draw comes from the generator of the tensor's device
(``framework.random.generator_for``, reseeded by ``seed()``), never from
torch's global RNG; the same seed gives the same draws on one device.
The values are torch's, not JAX's (another generator).  Without
``place`` a tensor is drawn on the default device.  ``seed != 0`` in
``uniform`` draws from a generator of its own seeded with it, as the JAX
package's ``PRNGKey(seed)``."""
from __future__ import annotations

import torch

from ..framework.random import generator_for
from ._common import DEFAULT_FLOAT, device_of, dtype_or, f, t

__all__ = ["uniform", "rand", "randn", "normal", "gaussian",
           "standard_normal", "randint", "randint_like", "randperm",
           "multinomial", "bernoulli", "poisson", "exponential", "uniform_",
           "normal_"]


def _shape(shape):
    if isinstance(shape, torch.Tensor):
        shape = shape.tolist()
    return (int(shape),) if isinstance(shape, int) else tuple(
        int(s) for s in shape)


def _gen(dev, seed=0):
    if seed:
        return torch.Generator(device=dev).manual_seed(int(seed))
    return generator_for(dev)


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None,
            place=None):
    dev = device_of(place)
    out = torch.empty(_shape(shape), dtype=dtype_or(dtype, DEFAULT_FLOAT),
                      device=dev)
    return out.uniform_(min, max, generator=_gen(dev, seed))


def rand(shape, dtype=None, name=None, place=None):
    return uniform(shape, dtype, 0.0, 1.0, place=place)


def standard_normal(shape, dtype=None, name=None, place=None):
    dev = device_of(place)
    return torch.randn(_shape(shape), dtype=dtype_or(dtype, DEFAULT_FLOAT),
                       device=dev, generator=_gen(dev))


randn = standard_normal


def gaussian(shape, mean=0.0, std=1.0, dtype=None, name=None, place=None):
    """Drawn in the requested dtype (a float64 draw keeps float64's
    tails)."""
    return standard_normal(shape, dtype, place=place) * std + mean


def normal(mean=0.0, std=1.0, shape=None, name=None, place=None):
    """Tensors ``mean`` / ``std`` broadcast (to ``shape`` if given);
    numbers draw ``shape`` (a 0-d tensor without it)."""
    if isinstance(mean, torch.Tensor) or isinstance(std, torch.Tensor):
        like = mean if isinstance(mean, torch.Tensor) else std
        m, s = f(mean, like), f(std, like)
        if shape is None:
            shape = torch.broadcast_shapes(m.shape, s.shape)
        z = standard_normal(shape, place=like.device)
        return z * s + m
    return standard_normal(shape or (), place=place) * std + mean


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None,
            place=None):
    if high is None:
        low, high = 0, low
    dev = device_of(place)
    return torch.randint(int(low), int(high), _shape(shape),
                         dtype=dtype_or(dtype), device=dev,
                         generator=_gen(dev))


def randint_like(x, low=0, high=None, dtype=None, name=None):
    x = t(x)
    return randint(low, high, x.shape, dtype or x.dtype, place=x.device)


def randperm(n, dtype="int64", name=None, place=None):
    dev = device_of(place)
    return torch.randperm(int(n), dtype=dtype_or(dtype), device=dev,
                          generator=_gen(dev))


def multinomial(x, num_samples=1, replacement=False, name=None):
    x = f(x)
    return torch.multinomial(x, num_samples, replacement,
                             generator=_gen(x.device))


def bernoulli(x, name=None):
    x = t(x)
    p = x if x.is_floating_point() else x.to(DEFAULT_FLOAT)
    return torch.bernoulli(p, generator=_gen(x.device)).to(x.dtype)


def poisson(x, name=None):
    x = t(x)
    return torch.poisson(f(x), generator=_gen(x.device)).to(x.dtype)


def exponential(x_or_lam=1.0, shape=None, name=None, place=None):
    """A tensor: one draw per entry at its rate; a number: ``shape`` draws
    at that rate."""
    if shape is None and isinstance(x_or_lam, torch.Tensor):
        x = f(x_or_lam)
        e = torch.empty_like(x).exponential_(1.0, generator=_gen(x.device))
        return e / x
    dev = device_of(place)
    e = torch.empty(_shape(shape or ()), dtype=DEFAULT_FLOAT, device=dev)
    return e.exponential_(1.0, generator=_gen(dev)) / x_or_lam


def uniform_(x, min=-1.0, max=1.0):
    """Fills ``x`` in place (the JAX package returns a new array; the
    port's tensors are mutable) and returns it."""
    x = t(x)
    with torch.no_grad():
        return x.uniform_(min, max, generator=_gen(x.device))


def normal_(x, mean=0.0, std=1.0):
    x = t(x)
    with torch.no_grad():
        return x.normal_(mean, std, generator=_gen(x.device))
