"""Numerical kernels: normal distribution, solvers, NPV.

Port of ``adrates_tpu/utils/math.py``. The array functions are torch (so
``torch.func`` transforms go through them) and keep the JAX module's
formulas and order of operations; ``torch.special`` stands where that
module uses ``jax.scipy``. The vector conveniences of its compat surface
are host numpy, as there.
"""

from __future__ import annotations

import math as _math

import numpy as np
import torch

from .global_vars import gSmall

PI = 3.14159265358979323846
INVROOT2PI = 0.3989422804014327
# the reference's module constants (names kept for parity)
inv_root_two_pi = INVROOT2PI
ONE_MILLION = 1_000_000
TEN_MILLION = 10_000_000
ONE_BILLION = 1_000_000_000


def _f64(x) -> torch.Tensor:
    """``x`` as a float64 tensor (a tensor keeps its device)."""
    if torch.is_tensor(x):
        return x.to(torch.float64)
    return torch.as_tensor(np.array(x, dtype=np.float64))


def normpdf(x):
    """Standard normal density."""
    x = _f64(x)
    return torch.exp(-x * x / 2.0) * INVROOT2PI


def N(x):
    """Standard normal CDF (erf-based)."""
    x = _f64(x)
    return 0.5 * (1.0 + torch.special.erf(x / _math.sqrt(2.0)))


def normcdf(x):
    return N(x)


def norminvcdf(p):
    """Inverse standard normal CDF."""
    p = _f64(p)
    return _math.sqrt(2.0) * torch.special.erfinv(2.0 * p - 1.0)


def _gauss_legendre_20(like: torch.Tensor):
    nodes, weights = np.polynomial.legendre.leggauss(20)
    return (torch.as_tensor(nodes, device=like.device),
            torch.as_tensor(weights, device=like.device))


def phi2(h1, hk, r):
    """Bivariate standard normal CDF P(X<h1, Y<hk) with correlation r:
    20-point Gauss-Legendre quadrature over [0, r] (differentiable)."""
    h1 = _f64(h1)
    hk = _f64(hk)
    r = torch.clamp(_f64(r), -1.0 + 1e-12, 1.0 - 1e-12)
    nodes, weights = _gauss_legendre_20(h1)
    t = 0.5 * (nodes + 1.0)  # [0,1]
    rho = r * t
    denom = torch.sqrt(1.0 - rho ** 2)
    integrand = torch.exp(-(h1 ** 2 - 2.0 * rho * h1 * hk + hk ** 2)
                          / (2.0 * denom ** 2)) / denom
    integral = 0.5 * r * torch.sum(weights * integrand) / (2.0 * PI)
    return N(h1) * N(hk) + integral


def M(a, b, c):
    """Alias used by the reference for the bivariate CDF."""
    return phi2(a, b, c)


def phi3(b1, b2, b3, r12, r13, r23, n_quad: int = 40):
    """Trivariate standard normal CDF via conditioning quadrature on X3."""
    nodes, weights = (torch.as_tensor(a) for a in
                      np.polynomial.hermite.hermgauss(n_quad))
    x = _math.sqrt(2.0) * nodes
    w = weights / _math.sqrt(PI)
    b1, b2, b3, r12, r13, r23 = (_f64(v) for v in (b1, b2, b3, r12, r13,
                                                   r23))
    mask = x < b3
    d1 = torch.sqrt(torch.clamp(1.0 - r13 ** 2, min=gSmall))
    d2 = torch.sqrt(torch.clamp(1.0 - r23 ** 2, min=gSmall))
    a1 = (b1 - r13 * x) / d1
    a2 = (b2 - r23 * x) / d2
    rho_cond = (r12 - r13 * r23) / (d1 * d2)
    vals = torch.func.vmap(lambda u, v: phi2(u, v, rho_cond))(a1, a2)
    return torch.sum(torch.where(mask, w * vals, 0.0))


def cholesky(a):
    """Cholesky factor (lower), differentiable."""
    return torch.linalg.cholesky(_f64(a))


def solve_tridiagonal(lower, diag, upper, rhs):
    """Tridiagonal solve by parallel cyclic reduction (PCR).

    lower[0] and upper[-1] are ignored; all inputs have length n on their
    last axis (leading axes batch). ``ceil(log2 n)`` whole-vector
    elimination steps with the shifts built by concatenation and no
    in-place writes, so ``torch.func`` transforms go through it; the same
    steps in the same order as the JAX package's solver.
    """
    a = _f64(lower)
    b = _f64(diag)
    c = _f64(upper)
    d = _f64(rhs)
    n = b.shape[-1]
    a = torch.cat([a.new_zeros(a.shape[:-1] + (1,)), a[..., 1:]], dim=-1)
    c = torch.cat([c[..., :n - 1], c.new_zeros(c.shape[:-1] + (1,))],
                  dim=-1)

    steps = max(1, _math.ceil(_math.log2(n))) if n > 1 else 0

    def shift_up(x, fill=0.0):    # x[i-stride]
        pad = torch.full(x.shape[:-1] + (stride,), fill, dtype=x.dtype,
                         device=x.device)
        return torch.cat([pad, x[..., :-stride]], dim=-1)

    def shift_dn(x, fill=0.0):    # x[i+stride]
        pad = torch.full(x.shape[:-1] + (stride,), fill, dtype=x.dtype,
                         device=x.device)
        return torch.cat([x[..., stride:], pad], dim=-1)

    stride = 1
    for _ in range(steps):
        b_up = shift_up(b, 1.0)
        b_dn = shift_dn(b, 1.0)
        alpha = -a / b_up
        gamma = -c / b_dn
        a_new = alpha * shift_up(a)
        b_new = b + alpha * shift_up(c) + gamma * shift_dn(a)
        c_new = gamma * shift_dn(c)
        d_new = d + alpha * shift_up(d) + gamma * shift_dn(d)
        a, b, c, d = a_new, b_new, c_new, d_new
        stride *= 2

    return d / b


def npv(times, amounts, rate):
    """Continuous-compounding NPV of a cashflow strip."""
    times = _f64(times)
    amounts = _f64(amounts)
    return torch.sum(amounts * torch.exp(-rate * times))


def accrued_interpolator(t, coupon_times, coupon_amounts):
    """Linear accrual between coupon dates (reference math.py:66)."""
    t = _f64(t)
    coupon_times = _f64(coupon_times)
    coupon_amounts = _f64(coupon_amounts)
    n = coupon_times.shape[0]
    idx = torch.clamp(torch.searchsorted(coupon_times, t, right=True),
                      1, n - 1)
    t0 = coupon_times[idx - 1]
    t1 = coupon_times[idx]
    c = coupon_amounts[idx]
    return c * (t - t0) / torch.clamp(t1 - t0, min=gSmall)


def test_monotonicity(x) -> bool:
    x = _f64(x)
    return bool(torch.all(x[1:] > x[:-1]))


def test_range(x, lower, upper) -> bool:
    x = _f64(x)
    return bool(torch.all((x >= lower) & (x <= upper)))


def uniform_to_default_time(u, times, survival_probs):
    """Map a uniform draw to a default time by inverting the survival curve
    (reference helpers.py njit kernel semantics)."""
    u = float(u)
    times = np.asarray(times)
    sp = np.asarray(survival_probs)
    if u >= sp[-1]:
        idx = np.searchsorted(sp[::-1], u)
        n = sp.size
        i = n - idx
        if i >= n:
            return float(times[-1])
        s0, s1 = sp[i - 1], sp[i]
        t0, t1 = times[i - 1], times[i]
        return float(t0 + (t1 - t0) * (s0 - u) / max(s0 - s1, 1e-15))
    return 99999.0


def maximum(a, b):
    return torch.maximum(_f64(a), _f64(b))


def minimum(a, b):
    return torch.minimum(_f64(a), _f64(b))


# ---------------------------------------------------------------------------
# Vector utility compat surface (reference math.py:105-800): host numpy
# conveniences, not device compute paths.

def scale(x, factor: float):
    """Scale every element of an array (reference math.py:105-111)."""
    return np.asarray(x, dtype=np.float64) * factor


def maxaxis(s):
    """Row-wise max of a 2-D array (reference math.py:163-180)."""
    return np.max(np.asarray(s), axis=1)


def minaxis(s):
    """Row-wise min of a 2-D array (reference math.py:186-203)."""
    return np.min(np.asarray(s), axis=1)


def covar(a, b):
    """2x2 population covariance matrix of two series
    (reference math.py:208-243)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    caa = np.mean(a * a) - np.mean(a) ** 2
    cbb = np.mean(b * b) - np.mean(b) ** 2
    cab = np.mean(a * b) - np.mean(a) * np.mean(b)
    return [[caa, cab], [cab, cbb]]


def pair_gcd(v1: float, v2: float) -> float:
    """Greatest common divisor of two integers by Euclid's algorithm
    (reference math.py:249-266)."""
    if v1 == 0 or v2 == 0:
        return 0
    v1, v2 = int(v1), int(v2)
    while v2 != 0:
        v1, v2 = v2, v1 % v2
    return abs(v1)


def nprime(x):
    """Standard normal PDF (reference math.py:271-277)."""
    return normpdf(x)


def heaviside(x):
    """Heaviside step, 1 for x >= 0 (reference math.py:282-287)."""
    return np.where(np.asarray(x) >= 0.0, 1.0, 0.0)


def frange(start, stop, step):
    """Inclusive-of-stop arithmetic range (reference math.py:292-300)."""
    return list(range(start, stop + 1, step)) if isinstance(start, int) \
        and isinstance(stop, int) and isinstance(step, int) \
        else list(np.arange(start, stop + step * 0.5, step))


def n_vect(x):
    """Vectorised normal CDF (reference math.py:346-347)."""
    return N(x)


def n_prime_vect(x):
    """Vectorised normal PDF (reference math.py:353-354)."""
    return normpdf(x)


def normcdf_integrate(x: float) -> float:
    """Normal CDF by trapezoidal integration from -6 (reference
    math.py:360-386; a checking function, vectorised here)."""
    num_steps = 10000
    grid = np.linspace(-6.0, float(x), num_steps + 1)
    fx = np.exp(-grid * grid / 2.0)
    return float(np.trapezoid(fx, grid) / np.sqrt(2.0 * np.pi))


def normcdf_slow(z: float) -> float:
    """Normal CDF accurate to ~1e-15 (erfc)."""
    return 0.5 * _math.erfc(-float(z) / _math.sqrt(2.0))


def corr_matrix_generator(rho: float, n: int):
    """Flat-correlation full-rank n x n matrix (reference math.py:683-694)."""
    return rho * np.ones((n, n)) + (1.0 - rho) * np.eye(n)


def band_matrix_multiplication(A, m1: int, m2: int, b):
    """Multiply a band matrix in compact storage by a vector (reference
    math.py:713-731): row i of A holds bands A[i, j-i+m1] for
    j in [i-m1, i+m2]."""
    A = np.asarray(A, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    n = A.shape[0]
    x = np.zeros(n)
    for k in range(m1 + m2 + 1):       # one vector op per band, not per row
        off = k - m1                   # column offset j - i
        i = np.arange(max(0, -off), min(n, n - off))
        x[i] += A[i, k] * b[i + off]
    return x


def solve_tridiagonal_matrix(A, r):
    """Solve A u = r for tridiagonal A in (n, 3) compact rows (a, b, c)
    with a[0]/c[-1] unused (reference math.py:734-773), through the PCR
    solver above; returns numpy."""
    A = np.asarray(A, dtype=np.float64)
    if A.ndim != 2 or A.shape[1] != 3:
        raise ValueError(f"A must be (n, 3) compact tridiagonal, got "
                         f"{A.shape}")
    if A[0, 1] == 0.0:
        raise ValueError("First diagonal entry is zero, rewrite as a set "
                         "of N-1 equations")
    return solve_tridiagonal(A[:, 0], A[:, 1], A[:, 2],
                             np.asarray(r, dtype=np.float64)).numpy()


def transpose_tridiagonal_matrix(A):
    """Compact rows of A.T for tridiagonal A in (n, 3) storage: the a/c
    columns swapped and shifted by one row ((A.T)[i, i-1] = c[i-1]), so
    solve(transpose(A), r) solves A.T u = r."""
    A = np.asarray(A, dtype=np.float64)
    out = np.zeros_like(A)
    out[:, 1] = A[:, 1]
    out[1:, 0] = A[:-1, 2]
    out[:-1, 2] = A[1:, 0]
    return out
