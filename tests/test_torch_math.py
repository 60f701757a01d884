"""``adrates_torch.utils.math`` against ``adrates_tpu.utils.math`` on the
CPU, on inputs drawn from a seed with numpy.

``solve_tridiagonal`` (parallel cyclic reduction) for n = 1, 2, 3, 7 and
64 on diagonally dominant systems: the solution and its jacobian in each
of the four bands (``torch.func.jacrev`` against ``jax.jacrev``), and the
same solve batched over a leading axis; the normal-distribution functions
(values and gradients), the bivariate and trivariate CDFs, the NPV, the
accrual interpolator, Cholesky and the host compat helpers.

Tolerance: 1e-10 x max|ref| (values, jacobians); host helpers exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacrev

import adrates_tpu  # noqa: F401 — enables x64 for the JAX side
from adrates_tpu.utils import math as jm
from adrates_torch.utils import math as tm

SEED = 20240101


def _close(got, ref, tol=1e-10):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1e-300))


def _system(n: int, seed: int = SEED):
    rng = np.random.default_rng(seed + n)
    lower = rng.uniform(-1.0, 1.0, n)
    upper = rng.uniform(-1.0, 1.0, n)
    diag = 3.0 + rng.uniform(0.0, 1.0, n)
    rhs = rng.normal(0.0, 1.0, n)
    return lower, diag, upper, rhs


@pytest.mark.parametrize("n", [1, 2, 3, 7, 64])
def test_solve_tridiagonal_matches_jax(n):
    args = _system(n)
    ref = np.asarray(jm.solve_tridiagonal(*map(jnp.asarray, args)))
    got = tm.solve_tridiagonal(*(torch.tensor(a) for a in args))
    _close(got, ref)
    dense = np.diag(args[1]) + np.diag(args[0][1:], -1) \
        + np.diag(args[2][:-1], 1)
    np.testing.assert_allclose(dense @ got.numpy(), args[3], rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("band", range(4))
@pytest.mark.parametrize("n", [1, 2, 3, 7, 64])
def test_solve_tridiagonal_jacobian_matches_jax(n, band):
    args = _system(n)

    def jf(x):
        a = list(map(jnp.asarray, args))
        a[band] = x
        return jm.solve_tridiagonal(*a)

    def tf(x):
        a = [torch.tensor(v) for v in args]
        a[band] = x
        return tm.solve_tridiagonal(*a)
    ref = np.asarray(jax.jacrev(jf)(jnp.asarray(args[band])))
    got = jacrev(tf)(torch.tensor(args[band]))
    _close(got, ref)


def test_solve_tridiagonal_batched():
    """A [3, n] right-hand side against one [n] matrix, row by row."""
    lower, diag, upper, _ = _system(9)
    rhs = np.random.default_rng(SEED).normal(0.0, 1.0, (3, 9))
    got = tm.solve_tridiagonal(torch.tensor(lower), torch.tensor(diag),
                               torch.tensor(upper), torch.tensor(rhs))
    for k in range(3):
        _close(got[k], jm.solve_tridiagonal(lower, diag, upper, rhs[k]))


X = np.random.default_rng(SEED).normal(0.0, 1.5, 11)


@pytest.mark.parametrize("name", ["normpdf", "N", "normcdf", "nprime",
                                  "n_vect", "n_prime_vect"])
def test_normal_functions_match_jax(name):
    ref = np.asarray(getattr(jm, name)(jnp.asarray(X)))
    _close(getattr(tm, name)(torch.tensor(X)), ref)
    gj = np.asarray(jax.grad(lambda x: jnp.sum(getattr(jm, name)(x)))(
        jnp.asarray(X)))
    gt = jacrev(lambda x: getattr(tm, name)(x).sum())(torch.tensor(X))
    _close(gt, gj)


def test_norminvcdf_matches_jax():
    p = np.random.default_rng(SEED).uniform(0.01, 0.99, 9)
    _close(tm.norminvcdf(torch.tensor(p)), jm.norminvcdf(jnp.asarray(p)))


@pytest.mark.parametrize("args", [(0.3, -0.2, 0.5), (-1.1, 0.7, -0.35),
                                  (1.4, 1.9, 0.9)])
def test_phi2_and_M_match_jax(args):
    ref = float(jm.phi2(*args))
    assert float(tm.phi2(*args)) == pytest.approx(ref, rel=1e-12, abs=1e-15)
    assert float(tm.M(*args)) == float(tm.phi2(*args))


def test_phi3_matches_jax():
    args = (0.4, -0.3, 0.8, 0.25, -0.1, 0.35)
    ref = float(jm.phi3(*args))
    assert float(tm.phi3(*args)) == pytest.approx(ref, rel=1e-12,
                                                  abs=1e-15)


def test_npv_accrual_and_cholesky_match_jax():
    rng = np.random.default_rng(SEED)
    times = np.sort(rng.uniform(0.1, 10.0, 8))
    amounts = rng.uniform(1.0, 5.0, 8)
    assert float(tm.npv(times, amounts, 0.031)) == pytest.approx(
        float(jm.npv(times, amounts, 0.031)), rel=1e-14)
    for t in (0.05, 2.5, float(times[3]), 9.9):
        assert float(tm.accrued_interpolator(t, times, amounts)) == \
            pytest.approx(float(jm.accrued_interpolator(t, times, amounts)),
                          rel=1e-14, abs=1e-15)
    a = rng.normal(0.0, 1.0, (4, 4))
    spd = a @ a.T + 4.0 * np.eye(4)
    _close(tm.cholesky(spd), jm.cholesky(spd))
    assert tm.test_monotonicity(times) and not tm.test_monotonicity(
        times[::-1])
    assert tm.test_range(times, 0.0, 10.0) == jm.test_range(times, 0.0, 10.0)
    _close(tm.maximum(times, 5.0), jm.maximum(times, 5.0))
    _close(tm.minimum(times, 5.0), jm.minimum(times, 5.0))


def test_host_helpers_match_jax():
    rng = np.random.default_rng(SEED)
    a, b = rng.normal(0.0, 1.0, 20), rng.normal(0.0, 1.0, 20)
    s = rng.normal(0.0, 1.0, (3, 5))
    A = rng.normal(0.0, 1.0, (6, 3))
    A[:, 1] += 4.0
    r = rng.normal(0.0, 1.0, 6)
    sp = np.sort(rng.uniform(0.2, 1.0, 6))[::-1]
    for f, args in [("scale", (a, 2.5)), ("maxaxis", (s,)),
                    ("minaxis", (s,)), ("covar", (a, b)),
                    ("pair_gcd", (84, 36)), ("heaviside", (a,)),
                    ("frange", (0.0, 1.0, 0.25)), ("frange", (1, 7, 2)),
                    ("normcdf_integrate", (0.7,)),
                    ("normcdf_slow", (-0.4,)),
                    ("corr_matrix_generator", (0.3, 4)),
                    ("band_matrix_multiplication", (A, 1, 1, r)),
                    ("transpose_tridiagonal_matrix", (A,)),
                    ("uniform_to_default_time", (0.5, np.arange(6.0), sp))]:
        np.testing.assert_array_equal(np.asarray(getattr(tm, f)(*args)),
                                      np.asarray(getattr(jm, f)(*args)),
                                      err_msg=f)
    _close(tm.solve_tridiagonal_matrix(A, r),
           jm.solve_tridiagonal_matrix(A, r))
    assert (tm.PI, tm.INVROOT2PI, tm.ONE_MILLION, tm.TEN_MILLION,
            tm.ONE_BILLION) == (jm.PI, jm.INVROOT2PI, jm.ONE_MILLION,
                                jm.TEN_MILLION, jm.ONE_BILLION)
