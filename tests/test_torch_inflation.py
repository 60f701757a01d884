"""The port's inflation layer against adrates_tpu on the CPU: CPI
references, the inflation curve and index, ZCIS and YoY host values, the
inflation stage and its native forward, and inflation books end to end.

Tolerances: host values and curve factors rtol 1e-12 (the port queries
its curves through static interpolation plans, the JAX package through
its dynamic interpolation: both are the same f64 arithmetic up to
rounding); stage plans and compiled tables exactly (integers) or to
1e-15 relative; the native forward and its jacobian 1e-14 relative;
book pvs, delta and gamma 1e-10 x max|ref| on the structured split, the
generic split and the staged path.
"""

import dataclasses

import numpy as np
import pytest
import torch

import adrates_tpu  # noqa: F401 — enables x64 for the JAX side
import torch_cases as cases
from adrates_tpu.parallel import multibook as jmb
from adrates_torch import interop
from adrates_torch.parallel import multibook as tmb

PKGS = ("adrates_tpu", "adrates_torch")
SEAS = {m: 1.0 + 0.004 * np.sin(2.0 * np.pi * m / 12.0)
        for m in range(1, 13)}


def _fixings(u):
    """Historical RPI prints around the value date 1 Jan 2024: the index's
    base date is 1 Oct 2023 (lag 3), so the 1 Dec 2023 print extends the
    fixed range a month past it."""
    return [(u.Date(1, 10, 2021), 281.0), (u.Date(1, 10, 2022), 287.5),
            (u.Date(1, 12, 2023), 294.1)]


def build_fixings_model(pkg):
    """The GBP OIS curve and a GBP RPI curve whose index carries
    seasonality and historical fixings."""
    import importlib
    u = importlib.import_module(f"{pkg}.utils")
    return cases.build_infl_model(pkg, seasonality_factors=SEAS,
                                  fixings=_fixings(u))


def fixings_trades_for(pkg, model):
    """Seasoned inflation trades whose CPI references hit the index's
    fixings: a quarterly YoY swap started 23 months ago (its next period
    has both ratio ends fixed, the one after only the start), a ZCIS
    started 6 months ago (fixed base, projected final), a forward-starting
    annual YoY (both ends projected), and a GBP OIS."""
    import importlib
    u = importlib.import_module(f"{pkg}.utils")
    rates = importlib.import_module(f"{pkg}.trades.rates")
    v = model.value_dt
    index = model.curves["GBP_RPI_INFLATION"]._used_swaps[0] \
        ._inflation_index
    F, S = u.FrequencyTypes, u.SwapTypes
    seasoned = rates.YoYInflationSwap(
        effective_dt=v.add_months(-23), term_dt_or_tenor="3Y",
        fixed_leg_type=S.PAY, fixed_rate=0.036, inflation_index=index,
        freq_type=F.QUARTERLY, notional=4_000_000, inflation_spread=0.0004)
    zcis = rates.ZeroCouponInflationSwap(
        effective_dt=v.add_months(-6), term_dt_or_tenor="7Y",
        fixed_leg_type=S.RECEIVE, fixed_rate=0.034, inflation_index=index,
        notional=6_000_000)
    fwd = rates.YoYInflationSwap(
        effective_dt=v.add_months(5), term_dt_or_tenor="6Y",
        fixed_leg_type=S.RECEIVE, fixed_rate=0.033, inflation_index=index,
        freq_type=F.ANNUAL, notional=3_000_000, inflation_spread=-0.0002)
    return [seasoned, zcis, fwd] + cases.infl_trades_for(pkg, model)[2:]


BOOKS = {"plain": (cases.build_infl_model, cases.infl_trades_for),
         "fixings": (build_fixings_model, fixings_trades_for)}


@pytest.fixture(scope="module", params=sorted(BOOKS))
def books(request):
    """The book's name; per package (model, base, tiled); the JAX tiled
    book's outputs at 3 scenarios."""
    build, trades_for = BOOKS[request.param]
    out = {}
    for pkg in PKGS:
        m = build(pkg)
        out[pkg] = (m,) + cases.compile_tiled(pkg, m, trades_for(pkg, m))
    jt = out["adrates_tpu"][2]
    q0 = jt.basket.quotes0
    sh = cases.shocks(jt.basket.n_quotes)
    ref = {k: np.asarray(v)
           for k, v in jmb.make_multibook_fn(jt)(q0, sh).items()}
    return request.param, out, q0, sh, ref


def _compare(out, ref):
    out = {k: v.numpy() for k, v in out.items()}
    assert sorted(out) == sorted(ref)
    for k in ("pvs", "delta", "gamma"):
        np.testing.assert_allclose(out[k], ref[k], rtol=0,
                                   atol=1e-10 * np.abs(ref[k]).max(),
                                   err_msg=k)


# ---------------------------------------------------------------------------
# CPI references, index and curve
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fixings_models():
    return {pkg: build_fixings_model(pkg) for pkg in PKGS}


def _curve_and_index(model):
    curve = model.curves["GBP_RPI_INFLATION"]
    return curve, curve._used_swaps[0]._inflation_index


@pytest.mark.parametrize("months,fixed", [
    (-30, False), (-20, True), (-4, True), (-2, True), (2, True),
    (3, False), (11, False), (40, False), (130, False)])
def test_cpi_ref(fixings_models, months, fixed):
    """Fixed references (a print covers the lagged date; seasonality
    applied) and projected ones (after the last print, or before the
    first) agree field by field."""
    from adrates_tpu.market.position.engine_inflation import _cpi_ref as jref
    from adrates_torch.market.position.engine_inflation import \
        _cpi_ref as tref
    refs = []
    for pkg, f in zip(PKGS, (jref, tref)):
        m = fixings_models[pkg]
        curve, index = _curve_and_index(m)
        refs.append(f(index, curve, m.value_dt.add_months(months),
                      m.value_dt))
    (jf, jv, jt, js), (tf, tv, tt, ts) = refs
    assert jf == tf == fixed
    np.testing.assert_allclose([tv, tt, ts], [jv, jt, js], rtol=1e-15)


@pytest.mark.parametrize("case", ["both_fixed", "den_fixed", "num_fixed",
                                  "projected"])
def test_infl_payment_cases(case):
    """The four fixed/projected cases of the ratio payment give the same
    row entries in both packages."""
    num = {"both_fixed": (True, 301.2, 0.0, 1.003),
           "num_fixed": (True, 301.2, 0.0, 1.003)}.get(
        case, (False, 0.0, 2.75, 1.002))
    den = {"both_fixed": (True, 290.4, 0.0, 0.998),
           "den_fixed": (True, 290.4, 0.0, 0.998)}.get(
        case, (False, 0.0, 1.75, 0.997))
    rows = []
    for mod in (jmb, tmb):
        row = dict(fix_t=[], fix_amt=[], fix_m=[],
                   flt=dict(pay=[], s=[], e=[], pa=[], ia=[], sp=[], no=[],
                            m=[]))
        mod._infl_payment(num, den, 293.0, -2.5e6, 0.0004, 3.1, row)
        rows.append(row)
    assert rows[0] == rows[1]
    assert bool(rows[1]["fix_t"]) == (case == "both_fixed")
    if case == "den_fixed":
        assert rows[1]["flt"]["e"] == [0.0]     # the t=0 factor column
    if case == "num_fixed":
        assert rows[1]["flt"]["s"] == [0.0]


def test_curve_factors_and_forward_index(fixings_models):
    jc, ji = _curve_and_index(fixings_models["adrates_tpu"])
    tc, ti = _curve_and_index(fixings_models["adrates_torch"])
    np.testing.assert_array_equal(tc._times.numpy(), np.asarray(jc._times))
    np.testing.assert_allclose(tc._dfs.numpy(), np.asarray(jc._dfs),
                               rtol=1e-15)
    assert tc._interp_type.name == jc._interp_type.name
    v = fixings_models["adrates_torch"].value_dt
    for k in (0, 1, 7, 29, 61, 200, 400):
        d = v.add_months(k).add_days(k % 9)
        np.testing.assert_allclose(tc.forward_index(d), jc.forward_index(d),
                                   rtol=1e-12)
        np.testing.assert_allclose(ti.get_index(d), ji.get_index(d),
                                   rtol=1e-12)
    np.testing.assert_allclose(tc.inflation_rate(v.add_months(3),
                                                 v.add_months(50)),
                               jc.inflation_rate(v.add_months(3),
                                                 v.add_months(50)),
                               rtol=1e-12)


@pytest.mark.parametrize("pkg", PKGS)
def test_refit_gate(fixings_models, pkg):
    """A quote the curve does not reprice fails the 1e-10 ZCIS gate."""
    curve, _ = _curve_and_index(cases.build_infl_model(pkg))
    curve._check_refits(1e-10)
    curve._used_swaps[2]._fixed_rate += 2e-10
    with pytest.raises(Exception, match="not repriced"):
        curve._check_refits(1e-10)


def test_host_values(fixings_models):
    """ZCIS and YoY ``value`` on the OIS discount curve and the inflation
    curve, and the ZCIS breakeven."""
    vals = []
    for pkg in PKGS:
        m = fixings_models[pkg]
        disc = m.curves["GBP_OIS_SONIA"]
        infl = m.curves["GBP_RPI_INFLATION"]
        trades = fixings_trades_for(pkg, m)[:3] \
            + cases.infl_trades_for(pkg, m)[:2]
        vals.append([t.value(m.value_dt, disc, infl) for t in trades]
                    + [trades[1].breakeven_inflation_rate(m.value_dt, disc,
                                                          infl),
                       trades[0].breakeven_rate(m.value_dt, disc, infl)])
    np.testing.assert_allclose(vals[1], vals[0], rtol=1e-12)


# ---------------------------------------------------------------------------
# the inflation stage
# ---------------------------------------------------------------------------


def test_stage_plans(books):
    _, out, *_ = books
    jb, tb = out["adrates_tpu"][1], out["adrates_torch"][1]
    assert [(s.kind, s.ids) for s in jb.basket._stages] == \
        [(s.kind, s.ids) for s in tb.basket.stages]
    a, b = jb.basket.params["bat"]["infl"], tb.basket.bat["infl"]
    for k in ("swap_times", "qidx", "pad_mask", "sent", "ts_static"):
        np.testing.assert_array_equal(np.asarray(a[k]), b[k], err_msg=k)
    for plan in ("row_plan", "row_plan_keep"):
        assert sorted(a[plan]) == sorted(b[plan])
        for scheme, p in b[plan].items():
            if isinstance(p, dict):
                for k, v in p.items():
                    np.testing.assert_array_equal(
                        np.asarray(a[plan][scheme][k]), v, err_msg=k)


def test_infl_native_ds_and_jacobian(books):
    import jax
    import jax.numpy as jnp
    from adrates_tpu.parallel.curve_batching import infl_native_ds as jnat
    from adrates_torch.parallel.curve_batching import (bat_to_torch,
                                                       infl_native_ds)
    _, out, q0, sh, _ = books
    jb, tb = out["adrates_tpu"][1], out["adrates_torch"][1]
    jbat = jb.basket.params["bat"]["infl"]
    tbat = bat_to_torch(tb.basket.bat, "cpu")["infl"]
    q = (q0 + sh[0])[np.asarray(tb.basket.bat["infl"]["qidx"])]
    ref = np.asarray(jnat(jnp.asarray(q), jbat))
    jref = np.asarray(jax.jacfwd(lambda x: jnat(x, jbat))(jnp.asarray(q)))
    qt = torch.as_tensor(q)
    got = infl_native_ds(qt, tbat).numpy()
    jac = torch.func.jacfwd(lambda x: infl_native_ds(x, tbat))(qt).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-14)
    np.testing.assert_allclose(jac, jref, rtol=0,
                               atol=1e-14 * np.abs(jref).max())
    assert float(np.abs(jac[:, 0]).max()) == 0.0   # the t=0 factor column


# ---------------------------------------------------------------------------
# books end to end
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("field", ["w_lin", "trip_s", "trip_e", "trip_p",
                                   "trip_w"])
def test_compiled_aggregate(books, field):
    _, out, *_ = books
    a = np.asarray(getattr(out["adrates_tpu"][2].aggregate, field))
    b = getattr(out["adrates_torch"][2].aggregate, field)
    if np.issubdtype(b.dtype, np.integer):
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(b, a, rtol=1e-15, atol=0)


def test_compiled_rows(books):
    _, out, *_ = books
    jb, tb = out["adrates_tpu"][1], out["adrates_torch"][1]
    np.testing.assert_array_equal(jb.basket.grid_sel, tb.basket.grid_sel)
    for a, b in zip(jb.buckets, tb.buckets):
        for f in dataclasses.fields(b):
            x, y = np.asarray(getattr(a, f.name)), getattr(b, f.name)
            np.testing.assert_allclose(y, x, rtol=1e-15, atol=0,
                                       err_msg=f.name)


@pytest.mark.parametrize("route", ["structured", "generic", "staged"])
def test_book_matches_jax(books, route):
    name, out, q0, sh, ref = books
    m, _, tiled = out["adrates_torch"]
    if route == "generic":
        _, tiled = cases.compile_tiled(
            "adrates_torch", m, BOOKS[name][1]("adrates_torch", m),
            batch_curves=False)
        fn = tmb.make_multibook_fn(tiled, "cpu")
        assert not fn.structured
    elif route == "staged":
        fn = tmb.make_staged_multibook_fn(tiled, "cpu")
    else:
        fn = tmb.make_multibook_fn(tiled, "cpu")
        assert fn.structured
    _compare(fn(q0, sh), ref)


def test_jax_compiled_book_through_interop(books):
    _, out, q0, sh, ref = books
    inputs = interop.multibook_from_numpy(
        **cases.jax_book_numpy(out["adrates_tpu"][2]))
    _compare(tmb.make_multibook_fn(inputs, "cpu")(q0, sh), ref)
