"""Dynamic interpolation and the leg pricers of the port against the JAX
package's, on the CPU.

``simple_df`` / ``interp_df`` against ``adrates_tpu``'s on every simple
scheme (the fitted schemes' state and values too; their jacobians and
Hessians are in test_torch_interp_fitted.py), at knots, between them, below the first and above the last node,
at t = 0 and within the 1e-10 knot guard, on a grid that starts at t = 0,
one with a repeated time and one anchored just above 0: values, ``jacrev``
and ``jacfwd(jacrev)`` in the DFs at 1e-10 x max|ref|, and the dynamic
plan equal bit for bit to the static one. ``pv_fixed_leg`` and the
dynamic ``pv_float_leg`` against the JAX functions on the same leg arrays
(``interop.fixed_leg_from_numpy`` / ``leg_from_numpy``) and the same grid:
PVs and their gradients in the DFs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd, jacrev

import torch_cases as tc
from adrates_tpu.ops import interpolation as jint
from adrates_tpu.ops import pricers as jpr
from adrates_torch import interop
from adrates_torch.ops import interpolation as tint
from adrates_torch.ops import pricers as tpr
from adrates_torch.utils.error import LibError
from adrates_torch.utils.global_types import InterpTypes as TIT
from adrates_tpu.utils.global_types import InterpTypes as JIT

SCHEMES = ["FLAT_FWD_RATES", "LINEAR_ZERO_RATES", "LINEAR_FWD_RATES"]
GRIDS = {
    "t0": ([0.0, 0.25, 0.5, 1.0, 2.0, 5.0, 10.0],
           [1.0, 0.9878, 0.9755, 0.952, 0.908, 0.79, 0.62]),
    "repeated": ([0.0, 0.5, 1.0, 1.0, 2.0, 5.0],
                 [1.0, 0.976, 0.953, 0.951, 0.909, 0.788]),
    "anchored": ([1e-8, 0.3, 0.9, 1.7, 3.0, 7.0],
                 [1.0, 0.985, 0.957, 0.921, 0.861, 0.701]),
}


def _t(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def _queries(times):
    t = np.asarray(times)
    mids = 0.5 * (t[1:] + t[:-1])
    return np.concatenate([t, mids, [-0.2, 0.0, t[-1] + 3.0, t[2] + 5e-11,
                                     t[3] - 4e-11, 0.7 * t[-1]]])


def _pair(grid, scheme):
    times, dfs = GRIDS[grid]
    q = _queries(times)
    jit_ = JIT[scheme]
    tit = TIT[scheme]

    def jf(d):
        return jint.simple_df(jnp.asarray(q), jnp.asarray(times), d, jit_)

    def tf(d):
        return tint.simple_df(_t(q), _t(times), d, tit)
    return (jf, jnp.asarray(dfs)), (tf, _t(dfs)), q, times


@pytest.mark.parametrize("measure", ["value", "jacrev", "hessian"])
@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("scheme", SCHEMES)
def test_simple_df_matches_jax(scheme, grid, measure):
    (jf, jd), (tf, td), _, _ = _pair(grid, scheme)
    if measure == "value":
        ref, got = np.asarray(jax.jit(jf)(jd)), tf(td).numpy()
    elif measure == "jacrev":
        ref = np.asarray(jax.jit(jax.jacrev(jf))(jd))
        got = jacrev(tf)(td).numpy()
    else:
        ref = np.asarray(jax.jit(jax.jacfwd(jax.jacrev(jf)))(jd))
        got = jacfwd(jacrev(tf))(td).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-10 * max(np.abs(ref).max(), 1e-300))


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("scheme", SCHEMES)
def test_dynamic_plan_equals_static_bit_for_bit(scheme, grid):
    _, (tf, td), q, times = _pair(grid, scheme)
    plan = tint.plan_to_torch(tint.simple_interp_plan(q, times, TIT[scheme]),
                              "cpu")
    static = tint.simple_df_static(plan, td, TIT[scheme])
    assert torch.equal(tf(td), static)


def test_scalar_query_and_interp_df():
    times, dfs = (_t(x) for x in GRIDS["t0"])
    for s in SCHEMES:
        it = TIT[s]
        one = tint.simple_df(0.7, times, dfs, it)
        assert one.shape == ()
        assert float(one) == float(tint.simple_df(_t([0.7]),
                                                  times, dfs, it)[0])
        assert tint.interp_fit(times, dfs, it) == tint.InterpAux()
        assert torch.equal(tint.interp_df(_t([0.7, 3.0]), times, dfs, it),
                           tint.simple_df(_t([0.7, 3.0]), times, dfs, it))


@pytest.mark.parametrize("scheme", ["PCHIP_LOG_DISCOUNT", "PCHIP_ZERO_RATES",
                                    "NATCUBIC_LOG_DISCOUNT",
                                    "NATCUBIC_ZERO_RATES",
                                    "FINCUBIC_ZERO_RATES"])
def test_fitted_schemes_raise(scheme):
    """The fitted schemes (ported; the name is kept from when they
    raised): ``interp_fit``'s state and ``interp_df`` at the GRIDS["t0"]
    queries against the JAX package's, at 1e-10 x max|ref|."""
    times, dfs = GRIDS["t0"]
    q = _queries(times)
    jx, jd = jnp.asarray(times), jnp.asarray(dfs)
    tx, td = _t(times), _t(dfs)
    ja = jint.interp_fit(jx, jd, JIT[scheme])
    ta = tint.interp_fit(tx, td, TIT[scheme])
    for k in ("y", "d", "c"):
        r, g = getattr(ja, k), getattr(ta, k)
        assert (r is None) == (g is None), k
        if r is not None:
            r = np.asarray(r)
            np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                       atol=1e-10 * np.abs(r).max(),
                                       err_msg=k)
    ref = np.asarray(jint.interp_df(jnp.asarray(q), jx, jd, JIT[scheme], ja))
    got = tint.interp_df(_t(q), tx, td, TIT[scheme], ta).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-10 * np.abs(ref).max())


# ---------------------------------------------------------------------------
# the leg pricers on the same leg arrays


def _fields(leg) -> dict:
    return {f.name: getattr(leg, f.name) for f in dataclasses.fields(leg)}


@pytest.fixture(scope="module")
def jax_state():
    """The JAX package's model, trades and leg tensors (numpy leaves)."""
    from adrates_tpu.market.position.engine_credit import _frn_tensor
    from adrates_tpu.market.position.engine_xccy import \
        _float_leg_xccy_tensor
    m = tc.build_credit_model("adrates_tpu")
    ois = tc.build_trades("adrates_tpu", tc.build_model("adrates_tpu"))
    credit = tc.credit_trades_for("adrates_tpu", m)
    v = m.value_dt
    gbp = m.curves["GBP_OIS_SONIA"]
    usd = m.curves["USD_OIS_SOFR"]
    fixed = [t._fixed_leg.tensor(v) for t in ois]
    flt = [t._float_leg.tensor(v, index_dc=gbp._dc_type) for t in ois]
    flt.append(_float_leg_xccy_tensor(credit[2]._foreign_leg, v,
                                      gbp._dc_type))
    flt += [_frn_tensor(credit[k], v, gbp._dc_type) for k in (3, 4)]
    from adrates_tpu.trades.credit import FRN
    first = FRN(v.add_months(-1), "3Y", quoted_margin=0.001,
                freq_type=credit[3]._freq_type, dc_type=credit[3]._dc_type,
                currency=credit[3]._currency,
                floating_index=credit[3]._floating_index,
                face_value=2e6, first_fixing_rate=0.051, cap_rate=0.06)
    flt.append(_frn_tensor(first, v, gbp._dc_type))
    return dict(
        fixed=fixed, flt=flt,
        grids=[(np.asarray(c._times), np.asarray(c._dfs), c._interp_type)
               for c in (gbp, usd)])


N_FIXED, N_FLOAT = 8, 11


@pytest.mark.parametrize("k", range(N_FIXED))
def test_pv_fixed_leg_matches_jax(jax_state, k):
    leg = jax_state["fixed"][k]
    (t0, d0, it), _ = jax_state["grids"]
    port = tpr.leg_to_torch(interop.fixed_leg_from_numpy(_fields(leg)),
                            "cpu")
    tit = TIT[it.name]

    def jf(d):
        return jpr.pv_fixed_leg(d, jnp.asarray(t0), it, leg)

    def tf(d):
        return tpr.pv_fixed_leg(d, _t(t0), tit, port)
    ref, got = float(jax.jit(jf)(jnp.asarray(d0))), float(tf(_t(d0)))
    assert got == pytest.approx(ref, rel=1e-10, abs=1e-8)
    gj = np.asarray(jax.jit(jax.grad(jf))(jnp.asarray(d0)))
    gt = jacrev(tf)(_t(d0)).numpy()
    np.testing.assert_allclose(gt, gj, rtol=0, atol=1e-10 * np.abs(gj).max())


@pytest.mark.parametrize("k", range(N_FLOAT))
def test_pv_float_leg_dynamic_matches_jax(jax_state, k):
    """Dual curve: discounted on the GBP grid, projected off the USD one
    (FLAT_FWD both), with notional exchanges, caps and a first fixing
    among the legs."""
    leg = jax_state["flt"][k]
    (t0, d0, it0), (t1, d1, it1) = jax_state["grids"]
    port = tpr.leg_to_torch(interop.leg_from_numpy(_fields(leg)), "cpu")
    tit0, tit1 = TIT[it0.name], TIT[it1.name]

    def jf(d, e):
        return jpr.pv_float_leg(d, jnp.asarray(t0), it0, leg, idx_dfs=e,
                                idx_times=jnp.asarray(t1),
                                idx_interp_type=it1)

    def tf(d, e):
        return tpr.pv_float_leg(d, tit0, port, idx_dfs=e,
                                idx_interp_type=tit1,
                                times=_t(t0),
                                idx_times=_t(t1))
    jd, je = jnp.asarray(d0), jnp.asarray(d1)
    td, te = _t(d0), _t(d1)
    ref, got = float(jax.jit(jf)(jd, je)), float(tf(td, te))
    assert got == pytest.approx(ref, rel=1e-10, abs=1e-8)
    for arg in (0, 1):
        gj = np.asarray(jax.jit(jax.grad(jf, argnums=arg))(jd, je))
        gt = jacrev(tf, argnums=arg)(td, te).numpy()
        np.testing.assert_allclose(gt, gj, rtol=0,
                                   atol=1e-10 * max(np.abs(gj).max(), 1e-300))


def test_pv_float_leg_needs_plans_or_times(jax_state):
    port = tpr.leg_to_torch(interop.leg_from_numpy(
        _fields(jax_state["flt"][0])), "cpu")
    with pytest.raises(LibError, match="plans or"):
        tpr.pv_float_leg(torch.ones(3, dtype=torch.float64),
                         TIT.FLAT_FWD_RATES, port)
