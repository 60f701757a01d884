"""The fitted interpolation schemes of the port against adrates_tpu's on
the CPU.

Each of the five fitted schemes (PCHIP_LOG_DISCOUNT, PCHIP_ZERO_RATES,
NATCUBIC_LOG_DISCOUNT, NATCUBIC_ZERO_RATES, FINCUBIC_ZERO_RATES) on a
grid with a t = 0 node, one anchored above 0, and one whose secants
change sign and vanish (equal neighbouring DFs), which takes PCHIP's 0/0
guards: ``interp_fit``'s state (y, d, c), ``interp_df`` at the knots,
between them, before the first and past the last (the last polynomial
extrapolates), its ``jacfwd`` and its Hessian in the DFs, each at 1e-10 x
max|ref|, with every derivative finite; the static plan
(``fitted_interp_plan``) equal bit for bit to the dynamic path; grids of
two and three knots; a [G, n] batch of DF rows fitted at once."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd, jacrev

import adrates_tpu  # noqa: F401 — enables x64 for the JAX side
from adrates_tpu.ops import interpolation as jint
from adrates_tpu.utils.global_types import InterpTypes as JIT
from adrates_torch.ops import interpolation as tint
from adrates_torch.utils.global_types import InterpTypes as TIT

SCHEMES = ["PCHIP_LOG_DISCOUNT", "PCHIP_ZERO_RATES", "NATCUBIC_LOG_DISCOUNT",
           "NATCUBIC_ZERO_RATES", "FINCUBIC_ZERO_RATES"]
GRIDS = {
    "t0": ([0.0, 0.25, 0.5, 1.0, 2.0, 5.0, 10.0, 30.0],
           [1.0, 0.9878, 0.9755, 0.952, 0.908, 0.79, 0.62, 0.27]),
    "anchored": ([0.1, 0.3, 0.9, 1.7, 3.0, 7.0],
                 [0.995, 0.985, 0.957, 0.921, 0.861, 0.701]),
    "sign_change": ([0.0, 0.5, 1.0, 2.0, 3.0, 4.0, 6.0],
                    [1.0, 0.99, 0.995, 0.995, 0.97, 0.975, 0.95]),
}
MEASURES = ["fit", "value", "jacfwd", "hessian"]


def _t(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def _queries(times):
    t = np.asarray(times)
    mids = 0.5 * (t[1:] + t[:-1])
    return np.concatenate([t, mids, [t[0] - 0.05, t[-1] + 4.0, 1.5 * t[-1],
                                     0.37 * t[-1]]])


def _close(got, ref, tol=1e-10, msg=""):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, msg
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1e-300),
                               err_msg=msg)


@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("scheme", SCHEMES)
def test_fitted_scheme_matches_jax(scheme, grid, measure):
    times, dfs = GRIDS[grid]
    q = _queries(times)
    jx, tx = jnp.asarray(times), _t(times)
    jit_, tit = JIT[scheme], TIT[scheme]
    if measure == "fit":
        ja, ta = jint.interp_fit(jx, jnp.asarray(dfs), jit_), \
            tint.interp_fit(tx, _t(dfs), tit)
        for k in ("y", "d", "c"):
            r, g = getattr(ja, k), getattr(ta, k)
            assert (r is None) == (g is None), k
            if r is not None:
                _close(g, r, msg=k)
        return

    def jf(d):
        return jint.interp_df(jnp.asarray(q), jx, d, jit_)

    def tf(d):
        return tint.interp_df(_t(q), tx, d, tit)
    if measure == "value":
        ref, got = jax.jit(jf)(jnp.asarray(dfs)), tf(_t(dfs))
    elif measure == "jacfwd":
        ref, got = jax.jit(jax.jacfwd(jf))(jnp.asarray(dfs)), \
            jacfwd(tf)(_t(dfs))
    else:
        ref, got = jax.jit(jax.hessian(jf))(jnp.asarray(dfs)), \
            jacfwd(jacrev(tf))(_t(dfs))
    assert bool(torch.isfinite(got).all())
    _close(got, ref)


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("scheme", SCHEMES)
def test_static_plan_equals_dynamic_bit_for_bit(scheme, grid):
    times, dfs = GRIDS[grid]
    q = _queries(times)
    it = TIT[scheme]
    plan = tint.plan_to_torch(tint.interp_plan(q, times, it), "cpu")
    assert torch.equal(tint.df_static(plan, _t(dfs), it),
                       tint.interp_df(_t(q), _t(times), _t(dfs), it))


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_short_grids_match_jax(scheme, n):
    times, dfs = (np.asarray(v)[:n] for v in GRIDS["t0"])
    times = times if n == 3 else np.array([0.0, 1.5])
    q = np.array([0.0, 0.4, 1.0, 1.2, 3.0])

    def jf(d):
        return jint.interp_df(jnp.asarray(q), jnp.asarray(times), d,
                              JIT[scheme])
    _close(tint.interp_df(_t(q), _t(times), _t(dfs), TIT[scheme]),
           jax.jit(jf)(jnp.asarray(dfs)))
    _close(jacfwd(lambda d: tint.interp_df(_t(q), _t(times), d,
                                           TIT[scheme]))(_t(dfs)),
           jax.jit(jax.jacfwd(jf))(jnp.asarray(dfs)))


@pytest.mark.parametrize("scheme", SCHEMES)
def test_batched_rows_fit_each_row(scheme):
    """A [3, n] stack of DF rows: each row equals its own 1-D fit, and a
    per-member plan list evaluates member g against row g."""
    times, dfs = GRIDS["t0"]
    rows = np.asarray(dfs)[None, :] ** np.array([[1.0], [1.1], [0.9]])
    q = _queries(times)
    it = TIT[scheme]
    plan = tint.plan_to_torch(tint.fitted_interp_plan(q, times, it), "cpu")
    got = tint.fitted_df_static(plan, _t(rows), it)
    for g in range(3):
        assert torch.equal(got[g], tint.interp_df(_t(q), _t(times),
                                                  _t(rows[g]), it))
    members = tint.df_static([plan] * 3, _t(rows), it)
    assert torch.equal(members, got)


def test_scalar_query_keeps_its_shape():
    times, dfs = (_t(x) for x in GRIDS["t0"])
    for s in SCHEMES:
        one = tint.interp_df(0.7, times, dfs, TIT[s])
        assert one.shape == ()
        assert float(one) == float(tint.interp_df(_t([0.7]), times, dfs,
                                                  TIT[s])[0])
