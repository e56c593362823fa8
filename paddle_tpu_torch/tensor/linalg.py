"""Linear algebra — port of ``paddle_tpu.tensor.linalg``.

bf16 products accumulate in float32 (cuBLAS's default, as the JAX
package's ``preferred_element_type``); ``lu`` returns 1-based pivots;
``slogdet`` stacks ``[sign, logabsdet]``; ``cross`` defaults to the first
axis of size 3; ``eig`` / ``eigvals`` / ``householder_product`` run on the
host in float64 (LAPACK), as the JAX package does."""
from __future__ import annotations

import numpy as np
import torch

from ._common import f, t

__all__ = [
    "matmul", "dot", "mm", "bmm", "mv", "t", "transpose_", "norm", "dist",
    "cond", "cov", "corrcoef", "cholesky", "cholesky_solve", "inverse",
    "det", "slogdet", "matrix_rank", "matrix_power", "qr", "lu", "svd",
    "pinv", "solve", "triangular_solve", "lstsq", "eig", "eigh", "eigvals",
    "eigvalsh", "multi_dot", "cross", "histogram", "bincount",
    "householder_product", "matrix_exp", "pca_lowrank",
]

_t = t


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    x, y = _t(x), _t(y)
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    if x.dtype != y.dtype:
        dt = torch.promote_types(x.dtype, y.dtype)
        x, y = x.to(dt), y.to(dt)
    return torch.matmul(x, y)


def dot(x, y, name=None):
    x, y = _t(x), _t(y)
    if x.dim() == 2:
        return (x * y).sum(-1)
    return torch.dot(x, y)


def mm(input, mat2, name=None):
    return torch.matmul(_t(input), _t(mat2))


def bmm(x, y, name=None):
    return torch.matmul(_t(x), _t(y))


def mv(x, vec, name=None):
    return torch.matmul(_t(x), _t(vec))


def t(input, name=None):
    x = _t(input)
    return x if x.dim() < 2 else x.transpose(-1, -2)


def transpose_(x, perm, name=None):
    return _t(x).permute(tuple(perm))


def norm(x, p="fro", axis=None, keepdim=False, name=None):
    x = f(x)
    if p == "fro":
        if axis is None:
            return x.square().sum().sqrt().reshape(
                (1,) * x.dim() if keepdim else ())
        if isinstance(axis, (list, tuple)):
            return torch.linalg.matrix_norm(x, "fro", tuple(axis), keepdim)
        return torch.linalg.vector_norm(x, 2, axis, keepdim)
    if p == "nuc":
        return torch.linalg.matrix_norm(x, "nuc", tuple(axis), keepdim)
    if axis is None:
        x, axis = x.reshape(-1), 0
    ax = tuple(axis) if isinstance(axis, (list, tuple)) else axis
    if p == float("inf"):
        return x.abs().amax(ax, keepdim)
    if p == float("-inf"):
        return x.abs().amin(ax, keepdim)
    if p == 0:
        return (x != 0).to(x.dtype).sum(ax, keepdim)
    return (x.abs() ** p).sum(ax, keepdim) ** (1.0 / p)


def dist(x, y, p=2, name=None):
    return norm(f(x) - f(y), p=p)


def cond(x, p=None, name=None):
    return torch.linalg.cond(f(x), p)


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    x = f(x)
    return torch.cov(x if rowvar else x.T, correction=1 if ddof else 0,
                     fweights=None if fweights is None else _t(fweights, x),
                     aweights=None if aweights is None else _t(aweights, x))


def corrcoef(x, rowvar=True, name=None):
    x = f(x)
    return torch.corrcoef(x if rowvar else x.T)


def cholesky(x, upper=False, name=None):
    return torch.linalg.cholesky(f(x), upper=upper)


def cholesky_solve(x, y, upper=False, name=None):
    """Solve ``A z = x`` with ``y`` the Cholesky factor of ``A``."""
    return torch.cholesky_solve(f(x), f(y), upper=upper)


def inverse(x, name=None):
    return torch.linalg.inv(f(x))


def det(x, name=None):
    return torch.linalg.det(f(x))


def slogdet(x, name=None):
    sign, logdet = torch.linalg.slogdet(f(x))
    return torch.stack([sign, logdet])


def matrix_rank(x, tol=None, hermitian=False, name=None):
    return torch.linalg.matrix_rank(f(x), rtol=tol, hermitian=hermitian)


def matrix_power(x, n, name=None):
    return torch.linalg.matrix_power(_t(x), n)


def qr(x, mode="reduced", name=None):
    out = torch.linalg.qr(f(x), mode=mode)
    return out.R if mode == "r" else tuple(out)


def lu(x, pivot=True, get_infos=False, name=None):
    lu_, piv = torch.linalg.lu_factor(f(x), pivot=pivot)
    piv = piv.to(torch.int32)  # 1-based, as LAPACK's (and JAX's + 1)
    if get_infos:
        return lu_, piv, torch.zeros((), dtype=torch.int32, device=piv.device)
    return lu_, piv


def svd(x, full_matrices=False, name=None):
    return tuple(torch.linalg.svd(f(x), full_matrices=full_matrices))


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return torch.linalg.pinv(f(x), rtol=rcond, hermitian=hermitian)


def solve(x, y, name=None):
    return torch.linalg.solve(f(x), f(y))


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    a = f(x)
    if transpose:
        a, upper = a.transpose(-1, -2), not upper
    return torch.linalg.solve_triangular(a, f(y), upper=upper,
                                         unitriangular=unitriangular)


def lstsq(x, y, rcond=None, driver=None, name=None):
    """``(solution, residuals, rank, singular values)`` as
    ``jnp.linalg.lstsq`` (numpy's layout: residuals empty unless the
    system is overdetermined with full rank)."""
    a, b = f(x), f(y)
    m, n = a.shape[-2:]
    rcond = torch.finfo(a.dtype).eps * max(m, n) if rcond is None else rcond
    sol = torch.linalg.pinv(a, rtol=rcond) @ b
    sv = torch.linalg.svdvals(a)
    rank = (sv > rcond * sv.amax(-1, keepdim=True)).sum(-1).to(torch.int32)
    if m > n and bool((rank == n).all()):
        r = b - a @ sol
        res = r.square().sum(-2) if b.dim() == a.dim() else r.square().sum()
        res = res.reshape(-1) if b.dim() == a.dim() else res.reshape(1)
    else:
        res = torch.zeros(0, dtype=a.dtype, device=a.device)
    return sol, res, rank, sv


def _host_lapack(x):
    return t(x).detach().cpu().numpy()


def eig(x, name=None):
    w, v = np.linalg.eig(_host_lapack(x))
    dev = t(x).device
    return torch.from_numpy(w).to(dev), torch.from_numpy(v).to(dev)


def eigh(x, UPLO="L", name=None):
    return tuple(torch.linalg.eigh(f(x), UPLO=UPLO))


def eigvals(x, name=None):
    return torch.from_numpy(np.linalg.eigvals(_host_lapack(x))).to(
        t(x).device)


def eigvalsh(x, UPLO="L", name=None):
    return torch.linalg.eigvalsh(f(x), UPLO=UPLO)


def multi_dot(x, name=None):
    return torch.linalg.multi_dot([_t(v) for v in x])


def cross(x, y, axis=9, name=None):
    x = _t(x)
    if axis == 9:  # paddle's default: the first axis of size 3
        axis = next(i for i, s in enumerate(x.shape) if s == 3)
    return torch.linalg.cross(x, _t(y, x), dim=axis)


def histogram(input, bins=100, min=0, max=0, name=None):
    """Counts over ``bins`` equal bins of ``[min, max]`` (both 0: the
    data's range), int64."""
    x = f(input).reshape(-1)
    if min == 0 and max == 0:
        lo, hi = float(x.min()), float(x.max())
    else:
        lo, hi = float(min), float(max)
    return torch.histc(x, bins=bins, min=lo, max=hi).to(torch.int64)


def bincount(x, weights=None, minlength=0, name=None):
    x = _t(x)
    return torch.bincount(x.long(), None if weights is None
                          else _t(weights, x), minlength=minlength)


def householder_product(x, tau, name=None):
    a = _t(x)
    return torch.linalg.householder_product(
        a.double(), _t(tau, a).double()).to(a.dtype)


def matrix_exp(x, name=None):
    return torch.linalg.matrix_exp(f(x))


def pca_lowrank(x, q=None, center=True, niter=2, name=None):
    """The exact SVD's leading ``q`` triples (the JAX package's
    definition: no randomized iterations)."""
    x = f(x)
    m, n = x.shape[-2], x.shape[-1]
    if q is None:
        q = min(6, m, n)
    if center:
        x = x - x.mean(-2, keepdim=True)
    u, s, vt = torch.linalg.svd(x, full_matrices=False)
    return u[..., :q], s[..., :q], vt.transpose(-1, -2)[..., :q]

