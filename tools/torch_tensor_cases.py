"""One call of every function that ``paddle_tpu.tensor`` exports, for
holding the port's tensor API against the JAX package
(``tests/test_torch_tensor_api.py``, on the CPU) and its CUDA results
against its CPU ones (``chip_smoke.py`` phase T1).

``CASES[name] = (make, kind)``: ``make(rng)`` returns ``(args, kwargs)``
of numpy arrays and Python values (every ``np.ndarray`` in them becomes
the package's tensor; nothing else is converted), and ``kind`` names how
results compare (``TOL`` and :func:`compare`).  ``RANDOM`` holds the
random functions, held to shapes, dtypes, moments and seeding instead of
to values.  Imports numpy only.
"""
from __future__ import annotations

import numpy as np

F32 = np.float32

#: (rtol, atol) by kind against the JAX package on the CPU, and (card vs
#: CPU) in ``CARD_TOL``: float32 elementwise ops agree to rounding;
#: special functions and reductions of many terms to a few ulps more;
#: factorizations and solves to the conditioning of the seeded matrices
TOL = {"exact": (0.0, 0.0), "float": (1e-5, 1e-6), "special": (1e-5, 1e-5),
       "linalg": (1e-4, 1e-5)}
CARD_TOL = {"exact": (0.0, 0.0), "float": (1e-5, 1e-5),
            "special": (1e-4, 1e-5), "linalg": (1e-3, 1e-4)}


def _r(rng, *shape):
    return rng.randn(*shape).astype(F32)


def _pos(rng, *shape):
    return (np.abs(rng.randn(*shape)) + 0.5).astype(F32)


def _unit(rng, *shape):
    return rng.uniform(0.05, 0.95, shape).astype(F32)


def _int(rng, *shape, lo=-5, hi=6):
    return rng.randint(lo, hi, shape).astype(np.int64)


def _spd(rng, n=4):
    a = rng.randn(n, n)
    return (a @ a.T + n * np.eye(n)).astype(F32)


def _well(rng, n=4):
    return (rng.randn(n, n) + n * np.eye(n)).astype(F32)


def _x(fn):
    """A case of one float32 [3, 4] input."""
    return lambda rng: ((fn(rng, 3, 4),), {})


def _xy(fx, fy=None):
    fy = fy or fx
    return lambda rng: ((fx(rng, 3, 4), fy(rng, 3, 4)), {})


def _call(*args, **kwargs):
    return lambda rng: (tuple(a(rng) if callable(a) else a for a in args),
                        {k: (v(rng) if callable(v) else v)
                         for k, v in kwargs.items()})


R34 = lambda rng: _r(rng, 3, 4)            # noqa: E731
I34 = lambda rng: _int(rng, 3, 4)          # noqa: E731
NZ34 = lambda rng: _int(rng, 3, 4, lo=1, hi=7) * np.where(  # noqa: E731
    rng.rand(3, 4) < 0.5, -1, 1)
B34 = lambda rng: rng.rand(3, 4) < 0.5     # noqa: E731
R234 = lambda rng: _r(rng, 2, 3, 4)        # noqa: E731
SPD = _spd
WELL = _well

CASES = {
    # -- creation -------------------------------------------------------------
    "to_tensor": (_call(R34), "exact"),
    "zeros": (_call([2, 3]), "exact"),
    "ones": (_call([2, 3], dtype="int32"), "exact"),
    "full": (_call([2, 3], 1.5), "exact"),
    "zeros_like": (_call(I34), "exact"),
    "ones_like": (_call(R34), "exact"),
    "full_like": (_call(R34, 2.5), "exact"),
    "empty": (_call([2, 2]), "exact"),
    "empty_like": (_call(R34), "exact"),
    "arange": (_call(1, 10, 2), "exact"),
    "linspace": (_call(0.0, 1.0, 7), "float"),
    "logspace": (_call(0.0, 2.0, 5), "float"),
    "eye": (_call(3, 4), "exact"),
    "meshgrid": (_call(lambda r: _r(r, 3), lambda r: _r(r, 2)), "exact"),
    "diag": (_call(lambda r: _r(r, 3), 1, padding_value=-1.0), "exact"),
    "diagflat": (_call(lambda r: _r(r, 2, 2), -1), "exact"),
    "tril": (_call(R34, 1), "exact"),
    "triu": (_call(R34, -1), "exact"),
    "tril_indices": (_call(4, 5, 1), "exact"),
    "triu_indices": (_call(4, 5, -1), "exact"),
    "assign": (_call(R34), "exact"),
    "clone": (_call(I34), "exact"),
    "complex": (_xy(_r), "exact"),
    "real": (_call(R34), "exact"),
    "imag": (_call(R34), "exact"),
    "numel": (_call(R234), "exact"),
    "one_hot": (_call(lambda r: r.randint(0, 5, (6,)).astype(np.int64), 5),
                "exact"),
    # -- math: binary -----------------------------------------------------------
    "add": (_xy(_r), "float"),
    "subtract": (_xy(_r), "float"),
    "multiply": (_xy(_r), "float"),
    "divide": (_call(I34, NZ34), "float"),
    "floor_divide": (_call(I34, NZ34), "exact"),
    "mod": (_call(I34, NZ34), "exact"),
    "floor_mod": (_call(R34, lambda r: -_pos(r, 3, 4)), "float"),
    "remainder": (_call(lambda r: _r(r, 3, 4) * 5, _pos), "float"),
    "pow": (_call(_pos, R34), "float"),
    "maximum": (_xy(_r), "exact"),
    "minimum": (_xy(_r), "exact"),
    "fmax": (_xy(_r), "exact"),
    "fmin": (_xy(_r), "exact"),
    "atan2": (_xy(_r), "float"),
    "logaddexp": (_xy(_r), "float"),
    "heaviside": (_call(lambda r: np.round(_r(r, 3, 4)), R34), "exact"),
    "gcd": (_call(I34, NZ34), "exact"),
    "lcm": (_call(NZ34, NZ34), "exact"),
    "hypot": (_xy(_r), "float"),
    "copysign": (_xy(_r), "exact"),
    "nextafter": (_xy(_r), "exact"),
    "ldexp": (_call(R34, I34), "float"),
    # -- math: unary ------------------------------------------------------------
    "abs": (_x(_r), "exact"),
    "neg": (_call(I34), "exact"),
    "exp": (_x(_r), "float"),
    "expm1": (_x(_r), "float"),
    "exp2": (_x(_r), "float"),
    "log": (_x(_pos), "float"),
    "log2": (_x(_pos), "float"),
    "log10": (_x(_pos), "float"),
    "log1p": (_x(_pos), "float"),
    "sqrt": (_x(_pos), "float"),
    "rsqrt": (_x(_pos), "float"),
    "square": (_call(I34), "exact"),
    "reciprocal": (_x(_pos), "float"),
    "sign": (_x(_r), "exact"),
    "floor": (_x(_r), "exact"),
    "ceil": (_x(_r), "exact"),
    "round": (_call(lambda r: np.array([0.5, 1.5, 2.5, -0.5, -1.7, 2.2],
                                       F32)), "exact"),
    "trunc": (_x(_r), "exact"),
    "frac": (_x(_r), "float"),
    "sin": (_x(_r), "float"),
    "cos": (_x(_r), "float"),
    "tan": (_x(_unit), "float"),
    "asin": (_x(_unit), "float"),
    "acos": (_x(_unit), "float"),
    "atan": (_x(_r), "float"),
    "sinh": (_x(_r), "float"),
    "cosh": (_x(_r), "float"),
    "tanh": (_x(_r), "float"),
    "asinh": (_x(_r), "float"),
    "acosh": (_call(lambda r: _pos(r, 3, 4) + 1.0), "float"),
    "atanh": (_x(_unit), "float"),
    "erf": (_x(_r), "float"),
    "erfinv": (_x(_unit), "special"),
    "sigmoid": (_x(_r), "float"),
    "logit": (_call(_unit, eps=0.1), "float"),
    "digamma": (_x(_pos), "special"),
    "lgamma": (_x(_pos), "special"),
    "angle": (_x(_r), "exact"),
    "conj": (_x(_r), "exact"),
    "deg2rad": (_x(_r), "float"),
    "rad2deg": (_x(_r), "float"),
    "i0": (_x(_r), "special"),
    "i0e": (_x(_r), "special"),
    "i1": (_x(_r), "special"),
    "i1e": (_x(_r), "special"),
    "sgn": (_x(_r), "exact"),
    "scale": (_call(R34, 2.0, 0.5, False, "tanh"), "float"),
    "clip": (_call(R34, -0.5, 0.5), "exact"),
    "stanh": (_x(_r), "float"),
    # -- math: reductions -----------------------------------------------------
    "sum": (_call(R234, [0, 2], keepdim=True), "float"),
    "nansum": (_call(lambda r: np.where(r.rand(3, 4) < 0.3, np.nan,
                                        _r(r, 3, 4)).astype(F32), 1),
               "float"),
    "mean": (_call(I34, 1), "float"),
    "nanmean": (_call(lambda r: np.where(r.rand(3, 4) < 0.3, np.nan,
                                         _r(r, 3, 4)).astype(F32)),
                "float"),
    "prod": (_call(R234, [1, 2]), "float"),
    "max": (_call(R234, [0, 1], True), "exact"),
    "min": (_call(R234, -1), "exact"),
    "amax": (_call(R234), "exact"),
    "amin": (_call(R234, 1, True), "exact"),
    "logsumexp": (_call(R234, [1, 2]), "float"),
    "all": (_call(B34, 0), "exact"),
    "any": (_call(B34, -1, True), "exact"),
    "count_nonzero": (_call(I34, 1), "exact"),
    # -- math: cumulative -------------------------------------------------------
    "cumsum": (_call(R34), "float"),
    "cumprod": (_call(R34, 1), "float"),
    "cummax": (_call(lambda r: r.randint(0, 4, (3, 6)).astype(F32), 1),
               "exact"),
    "cummin": (_call(lambda r: r.randint(0, 4, (3, 6)).astype(F32), 0),
               "exact"),
    "logcumsumexp": (_call(R34, 1), "float"),
    # -- math: misc -------------------------------------------------------------
    "addmm": (_call(lambda r: _r(r, 3, 2), R34, lambda r: _r(r, 4, 2),
                    0.5, 2.0), "float"),
    "inner": (_xy(_r), "float"),
    "outer": (_call(lambda r: _r(r, 3), lambda r: _r(r, 2, 2)), "float"),
    "multiplex": (_call([np.arange(6, dtype=F32).reshape(3, 2),
                         -np.arange(6, dtype=F32).reshape(3, 2)],
                        np.array([[1], [0], [1]], np.int64)), "exact"),
    "lerp": (_call(R34, R34, 0.3), "float"),
    "diff": (_call(R34, 1, 1, lambda r: _r(r, 3, 1)), "float"),
    "trapezoid": (_call(R34, dx=0.5), "float"),
    "isfinite": (_call(np.array([1.0, np.inf, -np.inf, np.nan], F32)),
                 "exact"),
    "isinf": (_call(np.array([1.0, np.inf, -np.inf, np.nan], F32)),
              "exact"),
    "isnan": (_call(np.array([1.0, np.inf, -np.inf, np.nan], F32)),
              "exact"),
    "nan_to_num": (_call(np.array([1.0, np.inf, -np.inf, np.nan], F32),
                         2.0), "exact"),
    "broadcast_shape": (_call([3, 1, 4], [2, 1]), "exact"),
    "increment": (_call(R34, 2.0), "float"),
    "kron": (_call(lambda r: _r(r, 2, 2), lambda r: _r(r, 2, 3)), "float"),
    "renorm": (_call(R34, 2.0, 0, 1.0), "float"),
    "trace": (_call(R234, 1, 1, 2), "float"),
    "diagonal": (_call(R234, 0, 0, 2), "exact"),
    "take": (_call(R34, np.array([[0, -1], [13, 5]], np.int64), "wrap"),
             "exact"),
    "add_n": (_call([np.ones((2, 2), F32), np.full((2, 2), 2.0, F32)]),
              "float"),
    "addcmul": (_call(R34, R34, R34, 0.5), "float"),
    # -- logic ------------------------------------------------------------------
    "equal": (_call(I34, I34), "exact"),
    "not_equal": (_call(I34, I34), "exact"),
    "greater_than": (_xy(_r), "exact"),
    "greater_equal": (_call(I34, I34), "exact"),
    "less_than": (_xy(_r), "exact"),
    "less_equal": (_call(I34, I34), "exact"),
    "equal_all": (_call(np.arange(4), np.arange(4)), "exact"),
    "allclose": (_call(R34, R34), "exact"),
    "isclose": (_call(np.array([1.0, 2.0], F32),
                      np.array([1.0 + 1e-6, 2.1], F32)), "exact"),
    "logical_and": (_xy(lambda r, *s: r.rand(*s) < 0.5), "exact"),
    "logical_or": (_xy(lambda r, *s: r.rand(*s) < 0.5), "exact"),
    "logical_xor": (_xy(lambda r, *s: r.rand(*s) < 0.5), "exact"),
    "logical_not": (_call(B34), "exact"),
    "bitwise_and": (_call(I34, I34), "exact"),
    "bitwise_or": (_call(I34, I34), "exact"),
    "bitwise_xor": (_call(I34, I34), "exact"),
    "bitwise_not": (_call(I34), "exact"),
    "bitwise_left_shift": (_call(I34, lambda r: _int(r, 3, 4, lo=0, hi=4)),
                           "exact"),
    "bitwise_right_shift": (_call(lambda r: _int(r, 3, 4, lo=0, hi=99),
                                  lambda r: _int(r, 3, 4, lo=0, hi=4)),
                            "exact"),
    "is_tensor": (_call(R34), "exact"),
    "is_empty": (_call(np.zeros((0, 3), F32)), "exact"),
    "isin": (_call(I34, np.array([0, 2, 4], np.int64)), "exact"),
    # -- manipulation -------------------------------------------------------------
    "reshape": (_call(R234, [4, -1]), "exact"),
    "flatten": (_call(R234, 1, 2), "exact"),
    "squeeze": (_call(lambda r: _r(r, 3, 1, 4, 1), [1, -1]), "exact"),
    "unsqueeze": (_call(R34, [0, 3]), "exact"),
    "transpose": (_call(R234, [2, 0, 1]), "exact"),
    "moveaxis": (_call(R234, 0, -1), "exact"),
    "concat": (_call([np.ones((2, 3), F32), np.zeros((1, 3), F32)], 0),
               "exact"),
    "stack": (_call([np.ones((2, 3), F32), np.zeros((2, 3), F32)], 1),
              "exact"),
    "unstack": (_call(R234, 1), "exact"),
    "split": (_call(lambda r: _r(r, 6, 2), 3), "exact"),
    "chunk": (_call(lambda r: _r(r, 7, 2), 3), "exact"),
    "tile": (_call(R34, [2, 1]), "exact"),
    "expand": (_call(lambda r: _r(r, 3, 1), [2, -1, 4]), "exact"),
    "expand_as": (_call(lambda r: _r(r, 1, 4), R34), "exact"),
    "broadcast_to": (_call(lambda r: _r(r, 1, 4), [3, 4]), "exact"),
    "broadcast_tensors": (_call([np.ones((3, 1), F32),
                                 np.zeros((1, 4), F32)]), "exact"),
    "flip": (_call(R234, [0, 2]), "exact"),
    "reverse": (_call(R234, 1), "exact"),
    "rot90": (_call(R34, 3), "exact"),
    "roll": (_call(R34, 2), "exact"),
    "gather": (_call(R34, np.array([2, 0, 2], np.int64), 0), "exact"),
    "gather_nd": (_call(R234, np.array([[0, 1], [1, 2]], np.int64)),
                  "exact"),
    "scatter": (_call(R34, np.array([2, 0], np.int64),
                      lambda r: _r(r, 2, 4), False), "exact"),
    "scatter_nd": (_call(np.array([[1], [3], [1]], np.int64),
                         np.array([9.0, 10.0, 11.0], F32), [5]), "float"),
    "scatter_nd_add": (_call(R34, np.array([[0, 1], [2, 3], [0, 1]],
                                           np.int64),
                             np.array([1.0, 2.0, 3.0], F32)), "float"),
    "index_select": (_call(R34, np.array([3, 0], np.int64), 1), "exact"),
    "index_sample": (_call(R34, np.array([[0, 3], [1, 1], [2, 0]],
                                         np.int64)), "exact"),
    "index_add": (_call(R34, np.array([0, 2], np.int64), 0,
                        lambda r: _r(r, 2, 4)), "float"),
    "index_put": (_call(R34, [np.array([0, 2], np.int64),
                              np.array([1, 3], np.int64)],
                        np.array([5.0, 6.0], F32)), "exact"),
    "put_along_axis": (_call(R34, np.array([[0], [3], [1]], np.int64), 7.0,
                             1), "exact"),
    "take_along_axis": (_call(R34, np.array([[0, 3], [1, 1], [2, 0]],
                                            np.int64), 1), "exact"),
    "slice": (_call(R234, [0, 2], [1, 1], [2, 3]), "exact"),
    "strided_slice": (_call(R234, [1, 2], [2, 0], [0, 4], [-1, 2]),
                      "exact"),
    "crop": (_call(R234, [2, 2, -1], [0, 1, 1]), "exact"),
    "pad": (_call(R34, [1, 2, 0, 1]), "exact"),
    "cast": (_call(R34, "int32"), "exact"),
    "repeat_interleave": (_call(R34, 2, 1), "exact"),
    "unbind": (_call(R234, 2), "exact"),
    "unique": (_call(lambda r: r.randint(0, 5, (12,)).astype(np.int64),
                     True, True, True), "exact"),
    "unique_consecutive": (_call(np.array([1, 1, 2, 2, 2, 3, 1, 1],
                                          np.int64), True, True), "exact"),
    "masked_select": (_call(R34, B34), "exact"),
    "masked_fill": (_call(R34, B34, -1.0), "exact"),
    "as_complex": (_call(lambda r: _r(r, 3, 2)), "exact"),
    "as_real": (_call(lambda r: _r(r, 3).astype(np.complex64)), "exact"),
    "view": (_call(R234, [6, 4]), "exact"),
    "view_as": (_call(R234, lambda r: _r(r, 4, 6)), "exact"),
    "tensordot": (_call(R234, lambda r: _r(r, 4, 3, 2), [[1, 2], [1, 0]]),
                  "float"),
    "atleast_1d": (_call(np.float32(3.0)), "exact"),
    "atleast_2d": (_call(lambda r: _r(r, 3)), "exact"),
    "atleast_3d": (_call(lambda r: _r(r, 3), R34), "exact"),
    "tolist": (_call(I34), "exact"),
    "shard_index": (_call(np.array([[1], [6], [12], [19]], np.int64), 20, 2,
                          1), "exact"),
    "tensor_split": (_call(lambda r: _r(r, 7, 2), [2, 5]), "exact"),
    "hsplit": (_call(lambda r: _r(r, 2, 6), 3), "exact"),
    "vsplit": (_call(lambda r: _r(r, 4, 2), [1, 3]), "exact"),
    "dsplit": (_call(lambda r: _r(r, 2, 2, 4), 2), "exact"),
    "hstack": (_call([np.ones((2, 1), F32), np.zeros((2, 2), F32)]),
               "exact"),
    "vstack": (_call([np.ones((3,), F32), np.zeros((3,), F32)]), "exact"),
    "dstack": (_call([np.ones((2, 2), F32), np.zeros((2, 2), F32)]),
               "exact"),
    "column_stack": (_call([np.ones((3,), F32), np.zeros((3, 2), F32)]),
                     "exact"),
    "row_stack": (_call([np.ones((1, 3), F32), np.zeros((2, 3), F32)]),
                  "exact"),
    # -- linalg -------------------------------------------------------------------
    "matmul": (_call(R234, lambda r: _r(r, 3, 2), transpose_x=True),
               "float"),
    "dot": (_xy(_r), "float"),
    "mm": (_call(R34, lambda r: _r(r, 4, 2)), "float"),
    "bmm": (_call(R234, lambda r: _r(r, 2, 4, 5)), "float"),
    "mv": (_call(R34, lambda r: _r(r, 4)), "float"),
    "t": (_call(R34), "exact"),
    "transpose_": (_call(R234, [1, 2, 0]), "exact"),
    "norm": (_call(R234, 3.0, [1, 2]), "float"),
    "dist": (_call(R34, R34, 1), "float"),
    "cond": (_call(WELL), "linalg"),
    "cov": (_call(lambda r: _r(r, 3, 8)), "float"),
    "corrcoef": (_call(lambda r: _r(r, 3, 8)), "float"),
    "cholesky": (_call(SPD), "linalg"),
    "cholesky_solve": (_call(lambda r: _r(r, 4, 2),
                             lambda r: np.linalg.cholesky(_spd(r)).astype(
                                 F32)), "linalg"),
    "inverse": (_call(WELL), "linalg"),
    "det": (_call(WELL), "linalg"),
    "slogdet": (_call(WELL), "linalg"),
    "matrix_rank": (_call(lambda r: np.outer(_r(r, 4), _r(r, 3))), "exact"),
    "matrix_power": (_call(lambda r: _r(r, 3, 3) * 0.5, 3), "float"),
    "qr": (_call(lambda r: _r(r, 5, 3)), "qr"),
    "lu": (_call(WELL), "linalg"),
    "svd": (_call(lambda r: _r(r, 5, 3)), "svd"),
    "pinv": (_call(lambda r: _r(r, 5, 3)), "linalg"),
    "solve": (_call(WELL, lambda r: _r(r, 4, 2)), "linalg"),
    "triangular_solve": (_call(lambda r: np.triu(_well(r)),
                               lambda r: _r(r, 4, 2)), "linalg"),
    "lstsq": (_call(lambda r: _r(r, 6, 3), lambda r: _r(r, 6, 2)),
              "linalg"),
    "eig": (_call(SPD), "eig"),
    "eigh": (_call(SPD), "eigh"),
    "eigvals": (_call(SPD), "eig"),
    "eigvalsh": (_call(SPD), "linalg"),
    "multi_dot": (_call([np.eye(3, dtype=F32) * 2, np.ones((3, 2), F32),
                         np.ones((2, 4), F32)]), "float"),
    "cross": (_call(lambda r: _r(r, 2, 3), lambda r: _r(r, 2, 3)), "float"),
    "histogram": (_call(lambda r: _r(r, 50), 5), "exact"),
    "bincount": (_call(np.array([0, 1, 1, 3, 1], np.int64),
                       np.array([0.5, 1.0, 1.0, 2.0, 0.25], F32)), "float"),
    "householder_product": (_call(lambda r: _r(r, 4, 3),
                                  lambda r: _unit(r, 3)), "linalg"),
    "matrix_exp": (_call(lambda r: _r(r, 3, 3) * 0.3), "linalg"),
    "pca_lowrank": (_call(lambda r: _r(r, 8, 5), 2), "pca"),
    # -- search ---------------------------------------------------------------------
    "argmax": (_call(R234, 1, True), "exact"),
    "argmin": (_call(R234), "exact"),
    "argsort": (_call(lambda r: r.randint(0, 3, (3, 6)).astype(F32), 1,
                      True), "exact"),
    "sort": (_call(R34, 0, True), "exact"),
    "topk": (_call(lambda r: r.randint(0, 4, (3, 6)).astype(F32), 3),
             "exact"),
    "where": (_call(B34, R34, R34), "exact"),
    "nonzero": (_call(B34), "exact"),
    "index_select_search": (_call(R34, np.array([1, 1], np.int64), 1),
                            "exact"),
    "kthvalue": (_call(R34, 2, 1, True), "exact"),
    "mode": (_call(lambda r: r.randint(0, 3, (3, 7)).astype(F32), 1),
             "exact"),
    "median": (_call(R34, 1), "float"),
    "nanmedian": (_call(lambda r: np.where(r.rand(3, 4) < 0.2, np.nan,
                                           _r(r, 3, 4)).astype(F32), 1),
                  "float"),
    "searchsorted": (_call(np.array([1.0, 2.0, 2.0, 5.0], F32),
                           np.array([2.0, 0.0, 6.0], F32), right=True),
                     "exact"),
    "bucketize": (_call(np.array([2.0, 0.0, 6.0], F32),
                        np.array([1.0, 2.0, 2.0, 5.0], F32)), "exact"),
    "masked_select_idx": (_call(R34, B34), "exact"),
    # -- stat, attribute, printing -----------------------------------------------
    "std": (_call(R234, [0, 2]), "float"),
    "var": (_call(R234, 1, False, True), "float"),
    "quantile": (_call(R34, [0.25, 0.5], 1), "float"),
    "nanquantile": (_call(lambda r: np.where(r.rand(3, 4) < 0.2, np.nan,
                                             _r(r, 3, 4)).astype(F32), 0.3,
                          1), "float"),
    "histogramdd": (_call(lambda r: _r(r, 20, 2), 3), "float"),
    "shape": (_call(R234), "exact"),
    "rank": (_call(R234), "exact"),
    "is_complex": (_call(R34), "exact"),
    "is_floating_point": (_call(R34), "exact"),
    "is_integer": (_call(I34), "exact"),
    "einsum": (_call("ijk,kl->ijl", R234, lambda r: _r(r, 4, 2)), "float"),
    "set_printoptions": (_call(precision=8), "exact"),
    "to_string": (_call(np.array([[1.5, 2.0]], F32)), "exact"),
}

#: the random functions: ``make(rng)`` as above; drawn twice from one seed
#: (equal), their shape and dtype against the JAX package's, and the
#: moments of large draws in ``MOMENTS``
RANDOM = {
    "uniform": _call([2000], min=-2.0, max=2.0),
    "rand": _call([2000]),
    "randn": _call([2000]),
    "normal": _call(1.0, 2.0, [2000]),
    "gaussian": _call([2000], 1.0, 2.0),
    "standard_normal": _call([2000]),
    "randint": _call(0, 10, [2000]),
    "randint_like": _call(np.zeros((2000,), np.int64), 0, 10),
    "randperm": _call(50),
    "multinomial": _call(np.array([0.1, 0.2, 0.7], F32), 2000, True),
    "bernoulli": _call(np.full((2000,), 0.3, F32)),
    "poisson": _call(np.full((2000,), 3.0, F32)),
    "exponential": _call(2.0, [2000]),
    "uniform_": _call(np.zeros((2000,), F32), 0.0, 1.0),
    "normal_": _call(np.zeros((2000,), F32), 1.0, 0.5),
}

#: (mean, std) of each draw's values and the bound on their error
MOMENTS = {
    "uniform": (0.0, 4 / 12 ** 0.5), "rand": (0.5, 1 / 12 ** 0.5),
    "randn": (0.0, 1.0), "normal": (1.0, 2.0), "gaussian": (1.0, 2.0),
    "standard_normal": (0.0, 1.0), "randint": (4.5, (99 / 12) ** 0.5),
    "randint_like": (4.5, (99 / 12) ** 0.5), "randperm": (24.5, None),
    "multinomial": (1.6, None), "bernoulli": (0.3, None),
    "poisson": (3.0, 3 ** 0.5), "exponential": (0.5, 0.5),
    "uniform_": (0.5, 1 / 12 ** 0.5), "normal_": (1.0, 0.5),
}

#: the modules ``paddle_tpu.tensor`` exposes by name
MODULES = ("attribute", "creation", "linalg", "logic", "manipulation",
           "math", "random", "search", "stat")


def convert(value, to):
    """Every ``np.ndarray`` in ``value`` (through lists and tuples) passed
    through ``to``."""
    if isinstance(value, np.ndarray):
        return to(value)
    if isinstance(value, (list, tuple)):
        return type(value)(convert(v, to) for v in value)
    return value


def to_host(value, as_numpy):
    """Results as nested numpy (``as_numpy`` turns one array or tensor
    into numpy); Python values pass through."""
    if isinstance(value, (list, tuple)):
        return [to_host(v, as_numpy) for v in value]
    if isinstance(value, (bool, int, float, str, type(None))):
        return value
    return as_numpy(value)


def _canonical(kind, v):
    """Sign- and order-free forms of factorizations: ``svd`` (U, S, Vᵀ)
    and ``pca`` (``pca_lowrank``'s U, S, V) as U·S·Vᵀ and S, ``qr`` as Q·R and |diag R|, ``eigh``
    as V·diag(w)·Vᵀ and w, ``eig`` the sorted eigenvalues."""
    if kind in ("svd", "pca"):
        u, s, v = (np.asarray(a) for a in v)
        vt = v if kind == "svd" else np.swapaxes(v, -1, -2)
        return [u @ np.diag(s) @ vt, s]
    if kind == "qr":
        q, r = v
        return [np.asarray(q) @ np.asarray(r), np.abs(np.diag(r))]
    if kind == "eigh":
        w, vec = v
        vec = np.asarray(vec)
        return [vec @ np.diag(w) @ vec.T, w]
    if kind == "eig":
        w = v[0] if isinstance(v, list) else v
        return np.sort_complex(np.asarray(w).astype(np.complex128))
    return v


def compare(kind, got, want, tol=None):
    """Assert ``got`` (nested numpy) equals ``want`` under ``kind``."""
    tol = tol or TOL
    if kind in ("svd", "pca", "qr", "eigh", "eig"):
        got, want, kind = _canonical(kind, got), _canonical(kind, want), \
            "linalg"
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), (got, want)
        for g, w in zip(got, want):
            compare(kind, g, w, tol)
        return
    if isinstance(want, (bool, int, float, str, type(None))) and not \
            isinstance(want, np.generic):
        if isinstance(got, np.ndarray) and got.shape == ():
            got = got.item()
        assert got == want or (isinstance(want, float) and np.isclose(
            got, want, *tol[kind] if kind != "exact" else (0, 0))), (
            got, want)
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.dtype.kind == want.dtype.kind or {
        got.dtype.kind, want.dtype.kind} <= {"i", "u"}, (got.dtype,
                                                       want.dtype)
    rtol, atol = tol[kind]
    if kind == "exact":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
