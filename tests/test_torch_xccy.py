"""adrates_torch XCCY layer against adrates_tpu: ``bootstrap_xccy``
(values, jacobian and Hessian in (spreads, dom-leg PVs, foreign DFs)),
the XCCY curve build and its refit gate, ``XccyBasisSwap.value``, the
foreign leg's compiled tensor, ``pv_float_leg`` on the calibration legs,
and the host compile of the OIS + XCCY book (basket order, grid axis and
its compaction metadata, stage plans, trip groups sharing quote rows).

Tolerances (measured on this book: values 0 to 2e-16, jacobian 2e-16
relative, Hessian 3e-15 relative): values 1e-13 absolute, jacobian
1e-11 x max|ref|, Hessian 1e-9 x max|ref|; host tables exact, weights
1e-15 relative."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd, jacrev

import adrates_tpu  # noqa: F401 — enables x64 for the JAX side
import torch_cases as cases
from adrates_tpu.market.position import engine_xccy as jengine
from adrates_tpu.ops import pricers as jpricers
from adrates_tpu.ops import xccy_bootstrap as jx
from adrates_tpu.parallel import multibook as jmb
from adrates_torch.ops import interpolation as tinterp
from adrates_torch.ops import pricers as tpricers
from adrates_torch.ops import xccy_bootstrap as tx
from adrates_torch.parallel import multibook as tmb
from adrates_torch.trades.rates import xccy_basis_swap as tswap
from adrates_torch.trades.rates.xccy_curve import find_xccy_curve
from adrates_torch.utils import LibError


@pytest.fixture(scope="module")
def models():
    return (cases.build_xccy_model("adrates_tpu"),
            cases.build_xccy_model("adrates_torch"))


@pytest.fixture(scope="module")
def books(models):
    jm, tm = models
    return (cases.compile_xccy_book("adrates_tpu", jm),
            cases.compile_xccy_book("adrates_torch", tm))


def _inputs(curve, case):
    """(spreads, pv_dom, foreign dfs) of the curve, quoted or shocked."""
    sp = np.asarray(curve.basis_spreads, dtype=np.float64)
    pv = np.asarray(curve._pv_domestic, dtype=np.float64)
    fd = np.asarray(curve._foreign_curve._dfs, dtype=np.float64)
    if case == "shocked":
        rng = np.random.default_rng(5)
        sp = sp + rng.normal(0.0, 2e-4, sp.shape)
        pv = pv * (1.0 + rng.normal(0.0, 1e-3, pv.shape))
        fd = fd * np.concatenate([[1.0], 1.0 + rng.normal(
            0.0, 1e-4, fd.shape[0] - 1)])
    return sp, pv, fd


@pytest.fixture(scope="module")
def jax_boot(models):
    """The JAX bootstrap of GBP_USD_XCCY as a jitted function of the
    concatenated inputs [spreads, pv_dom, foreign dfs], with its
    jacobian and Hessian."""
    jc = models[0].curves["GBP_USD_XCCY"]
    S = len(jc.basis_spreads)
    for_times = jnp.asarray(jc._foreign_curve._times)

    def f(x):
        return jx.bootstrap_xccy(
            x[:S], x[S:2 * S], for_times, x[2 * S:], jc._spot_fx, jc._plan,
            foreign_interp_type=jc._foreign_curve._interp_type,
            foreign_plan=jc._fplan)[1]

    return (jax.jit(f), jax.jit(jax.jacfwd(f)),
            jax.jit(jax.jacfwd(jax.jacrev(f))))


@pytest.mark.parametrize("case", ["quoted", "shocked"])
def test_bootstrap_xccy_values_jacobian_hessian(models, jax_boot, case):
    _, tm = models
    tc = tm.curves["GBP_USD_XCCY"]
    sp, pv, fd = _inputs(tc, case)
    S = sp.shape[0]
    x0 = np.concatenate([sp, pv, fd])
    jf, jjac, jhess = jax_boot
    tplan = tx.plan_to_torch(tc._plan, "cpu")
    fplan = tinterp.plan_to_torch(tc._fplan, "cpu")

    def tf(x):
        return tx.bootstrap_xccy(x[:S], x[S:2 * S], x[2 * S:], tc._spot_fx,
                                 tplan, tc._foreign_curve._interp_type,
                                 fplan)[1]

    xt = torch.tensor(x0)
    np.testing.assert_allclose(tf(xt).numpy(), np.asarray(jf(x0)),
                               rtol=0, atol=1e-13)
    jj = np.asarray(jjac(x0))
    np.testing.assert_allclose(jacrev(tf)(xt).numpy(), jj, rtol=0,
                               atol=1e-11 * np.abs(jj).max())
    hj = np.asarray(jhess(x0))
    np.testing.assert_allclose(jacfwd(jacrev(tf))(xt).numpy(), hj, rtol=0,
                               atol=1e-9 * np.abs(hj).max())


def test_xccy_curve_matches_jax(models):
    jm, tm = models
    jc, tc = jm.curves["GBP_USD_XCCY"], tm.curves["GBP_USD_XCCY"]
    np.testing.assert_allclose(tc._pv_domestic, jc._pv_domestic,
                               rtol=1e-14, atol=0)
    for f in dataclasses.fields(tc._plan):
        a, b = getattr(jc._plan, f.name), getattr(tc._plan, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(np.asarray(a), b, err_msg=f.name)
        else:
            assert a == b, f.name
    np.testing.assert_array_equal(tc._times.numpy(), np.asarray(jc._times))
    np.testing.assert_allclose(tc._dfs.numpy(), np.asarray(jc._dfs),
                               rtol=0, atol=1e-14)
    months = (1, 7, 30, 95, 130)
    np.testing.assert_allclose(
        tc.df([tm.value_dt.add_months(m) for m in months]),
        jc.df([jm.value_dt.add_months(m) for m in months]),
        rtol=0, atol=1e-14)


def test_refit_gate(models):
    """Every calibration swap reprices to par within 1e-10 of its
    notional in both packages, and the port's gate raises once the
    curve is moved off its calibration."""
    jm, tm = models
    jc, tc = jm.curves["GBP_USD_XCCY"], tm.curves["GBP_USD_XCCY"]
    for js, ts in zip(jc._used_swaps, tc._used_swaps):
        jv = js.value(value_dt=jm.value_dt, spot_fx=1.27,
                      domestic_discount_curve=jc._domestic_curve,
                      foreign_discount_curve=jc._foreign_curve,
                      xccy_discount_curve=jc)
        tv = ts.value(value_dt=tm.value_dt, spot_fx=1.27,
                      domestic_discount_curve=tc._domestic_curve,
                      foreign_discount_curve=tc._foreign_curve,
                      xccy_discount_curve=tc)
        assert abs(tv / ts._domestic_notional) < 1e-10
        assert abs(tv - jv) <= 1e-10 * ts._domestic_notional
    tc._check_refits(1e-10)
    saved = tc._dfs
    try:
        tc._dfs = saved * torch.cat([torch.ones(1, dtype=torch.float64),
                                     torch.full((saved.shape[0] - 1,),
                                                1.0 + 1e-6,
                                                dtype=torch.float64)])
        with pytest.raises(LibError, match="not repriced"):
            tc._check_refits(1e-10)
    finally:
        tc._dfs = saved


def test_basis_swap_value_and_leg_tensor(models):
    jm, tm = models
    jt = cases.build_xccy_trades("adrates_tpu", jm)[0][2]
    tt = cases.build_xccy_trades("adrates_torch", tm)[0][2]
    curves = {}
    for pkg, m in (("j", jm), ("t", tm)):
        curves[pkg] = dict(domestic_discount_curve=m.curves.USD_OIS_SOFR,
                           foreign_discount_curve=m.curves.GBP_OIS_SONIA,
                           xccy_discount_curve=m.curves["GBP_USD_XCCY"])
    jv = jt.value(jm.value_dt, spot_fx=1.27, **curves["j"])
    tv = tt.value(tm.value_dt, spot_fx=1.27, **curves["t"])
    np.testing.assert_allclose(tv, jv, rtol=1e-12, atol=0)
    assert abs(tv) > 1e3

    from adrates_tpu.utils import DayCountTypes as JDC
    from adrates_torch.utils import DayCountTypes as TDC
    a = jengine._float_leg_xccy_tensor(jt._foreign_leg, jm.value_dt,
                                       JDC.ACT_365F)
    b = tswap.float_leg_xccy_tensor(tt._foreign_leg, tm.value_dt,
                                    TDC.ACT_365F)
    for f in dataclasses.fields(b):
        np.testing.assert_array_equal(np.asarray(getattr(a, f.name)),
                                      np.asarray(getattr(b, f.name)),
                                      err_msg=f.name)


def test_pv_float_leg_on_calibration_legs(books):
    """The calibration domestic legs through the static plans, with the
    forwards projected off a second grid (one grid for both telescopes
    to PV 0 exactly): PVs and their jacobian in both grids, against
    JAX."""
    jb, tb = books
    key = next(st.key for st in tb.basket.stages if st.kind == "xccy")
    jbat = jb.basket.params["bat"][key]
    st = next(s for s in tb.basket.stages if s.key == key)
    jst = next(s for s in jb.basket._stages if s.key == key)
    rng = np.random.default_rng(9)
    ts = np.minimum(jbat["dom_ts"][0], 40.0)
    L = ts.shape[0]
    x0 = np.concatenate([
        np.exp(-0.04 * ts) * (1.0 + np.concatenate(
            [[0.0], rng.normal(0.0, 1e-4, L - 1)])),
        np.exp(-0.045 * ts)])
    legs, lp = jbat["legs"], jbat["legs_plan"]

    def jf(x):
        return jax.vmap(lambda lt, i_, d_: jpricers.pv_float_leg(
            x[:L], jnp.asarray(jbat["dom_ts"][0]), jst.dom_interp, lt,
            idx_dfs=x[L:], idx_times=jnp.asarray(jbat["dom_ts"][0]),
            plans=dict(idx=i_, disc=d_)))(
                jax.tree.map(lambda a: a[0], legs),
                jax.tree.map(lambda a: a[0], lp["idx"]),
                jax.tree.map(lambda a: a[0], lp["disc"]))

    dev = tmb._device_book(tmb.book_inputs(tb), "cpu").params["bat"][key]
    leg0 = {k: (v if isinstance(v, bool) else v[0])
            for k, v in dev["legs"].items()}
    plans0 = {k: {n: a[0] for n, a in v.items()}
              for k, v in dev["legs_plan"].items()}
    S = leg0["leg_sign"].shape[0]

    def tf(x):
        return tpricers.pv_float_leg(x[:L].expand(S, -1), st.dom_interp,
                                     leg0, plans0,
                                     idx_dfs=x[L:].expand(S, -1))

    ref = np.asarray(jf(x0))
    xt = torch.tensor(x0)
    np.testing.assert_allclose(tf(xt).numpy(), ref, rtol=1e-12, atol=0)
    assert np.abs(ref).min() > 1e3
    jj = np.asarray(jax.jacrev(jf)(x0))
    np.testing.assert_allclose(jacrev(tf)(xt).numpy(), jj, rtol=0,
                               atol=1e-12 * np.abs(jj).max())
    assert np.isfinite(jj).all()


def test_basket_order_by_kind_and_name(books):
    jb, tb = books
    names = [s.name for s in tb.basket.specs]
    assert names == ["EUR_OIS_ESTR", "GBP_OIS_SONIA", "USD_OIS_SOFR",
                     "GBP_USD_XCCY"]
    assert names == [s.name for s in jb.basket.specs]
    for a, b in zip(jb.basket.specs, tb.basket.specs):
        assert (a.kind, a.offset, a.n_quotes, a.dom_id, a.for_id) == \
            (b.kind, b.offset, b.n_quotes, b.dom_id, b.for_id)
    np.testing.assert_array_equal(jb.basket.quotes0, tb.basket.quotes0)


@pytest.mark.parametrize("name", ["grid_sel", "grid_inv", "grid_curve_of",
                                  "grid_offsets", "grid_keep_of"])
def test_grid_metadata(books, name):
    jb, tb = books
    a, b = getattr(jb.basket, name), getattr(tb.basket, name)
    if name == "grid_keep_of":
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), y)
    else:
        np.testing.assert_array_equal(np.asarray(a), b)
    assert jb.basket._grid_dense == tb.basket.grid_dense is False


def test_rows_and_aggregate(books):
    jb, tb = books
    np.testing.assert_array_equal(jb.unique_times, tb.unique_times)
    for f in ("trip_s", "trip_e", "trip_p"):
        np.testing.assert_array_equal(np.asarray(getattr(jb.aggregate, f)),
                                      getattr(tb.aggregate, f))
    for f in ("w_lin", "trip_w"):
        np.testing.assert_allclose(getattr(tb.aggregate, f),
                                   np.asarray(getattr(jb.aggregate, f)),
                                   rtol=1e-15, atol=0)
    assert len(jb.cols) == len(tb.cols)
    for a, b in zip(jb.cols, tb.cols):
        np.testing.assert_array_equal(np.asarray(a.col_idx), b.col_idx)
        np.testing.assert_allclose(b.w, np.asarray(a.w), rtol=1e-15,
                                   atol=0)
    jax_w, port_w = cases.trade_slot_weights(jb, tb)
    np.testing.assert_allclose(port_w, jax_w, rtol=0,
                               atol=1e-15 * np.abs(jax_w).max())


def test_trip_groups_share_parent_rows(books):
    jb, tb = books
    jg = jmb._term1_trip_groups(jb.basket, jb.aggregate)
    tg = tmb._term1_trip_groups(tb.basket, tb.aggregate)
    assert len(jg) == len(tg)
    for a, b in zip(jg, tg):
        for k in ("tsel", "s_idx", "e_idx", "p_idx"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert tuple(a["segs"]) == tuple(b["segs"]) and a["k"] == b["k"]
    rows = [set(r for o, n in g["segs"] for r in range(o, o + n))
            for g in tg]
    assert any(rows[i] & rows[j] for i in range(len(rows))
               for j in range(i + 1, len(rows)))


def _same(a, b, name):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), name
        for k in a:
            _same(a[k], b[k], f"{name}.{k}")
    elif dataclasses.is_dataclass(b):
        for f in dataclasses.fields(b):
            _same(getattr(a, f.name), getattr(b, f.name),
                  f"{name}.{f.name}")
    elif isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=name)
    else:
        assert a == b, name


@pytest.mark.parametrize("field", ["plan", "legs", "qidx", "pad_mask",
                                   "ts_static", "dom_ts", "for_ts",
                                   "spot_fx", "pv_dom0", "fboot_plan",
                                   "legs_plan", "row_plan",
                                   "row_plan_keep"])
def test_stage_plans(books, field):
    jb, tb = books
    jst, tst = jb.basket._stages, tb.basket.stages
    assert [(s.kind, s.key, s.ids) for s in jst] == \
        [(s.kind, s.key, s.ids) for s in tst]
    for st in tst:
        b = tb.basket.bat[st.key]
        if field not in b:
            assert st.kind == "ois"
            continue
        a = jb.basket.params["bat"][st.key]
        if field == "plan" and st.kind == "ois":
            for f in dataclasses.fields(b["plan"]):
                _same(getattr(a["plan"], f.name), getattr(b["plan"], f.name),
                      f.name)
        else:
            _same(a[field], b[field], field)


def test_find_xccy_curve_needs_exact_pair(models):
    _, tm = models
    trade = cases.build_xccy_trades("adrates_torch", tm)[0][2]
    assert find_xccy_curve(tm, trade)[0] == "GBP_USD_XCCY"
    from adrates_torch.utils import CurveTypes
    trade._foreign_floating_index = CurveTypes.EUR_OIS_ESTR
    with pytest.raises(LibError, match="No XCCY curve"):
        find_xccy_curve(tm, trade)


def test_unported_paths_raise(models):
    """An XCCY curve on a fitted scheme of its own in a stage (ported; the
    name is kept from when the compile refused it): the book with
    GBP_USD_XCCY on PCHIP_ZERO_RATES compiles and its PVs, delta and gamma
    equal the JAX package's on its unbatched curve graph at 1e-10 x
    max|ref|. The pricer and the bootstrap still refuse to run with
    neither a static plan nor the grid's times."""
    from adrates_tpu.utils import InterpTypes as JInterpTypes
    from adrates_torch.utils import InterpTypes
    out = []
    for pkg, m, it in (("adrates_tpu", models[0], JInterpTypes),
                       ("adrates_torch", models[1], InterpTypes)):
        xccy = m._curves_dict["GBP_USD_XCCY"]
        old = xccy._interp_type
        xccy._interp_type = it.PCHIP_ZERO_RATES
        try:
            trades, coll = cases.build_xccy_trades(pkg, m)
            mod = jmb if pkg == "adrates_tpu" else tmb
            kw = dict(batch_curves=False) if pkg == "adrates_tpu" else {}
            out.append(mod.compile_multibook(
                trades, m, base_currency=mod.CurrencyTypes.USD,
                collateral_types=coll, **kw))
        finally:
            xccy._interp_type = old
    jb, tb = out
    assert tb.basket.specs[tb.basket.curve_id("GBP_USD_XCCY")] \
        .interp_type == InterpTypes.PCHIP_ZERO_RATES
    q0 = tb.basket.quotes0
    sh = cases.shocks(q0.shape[0], 2)
    ref = jmb.make_multibook_fn(jb)(jnp.asarray(q0), jnp.asarray(sh))
    got = tmb.make_multibook_fn(tb, "cpu")(q0, sh)
    for k in ("pvs", "delta", "gamma"):
        r = np.asarray(ref[k])
        np.testing.assert_allclose(got[k].numpy(), r, rtol=0,
                                   atol=1e-10 * np.abs(r).max(), err_msg=k)
    with pytest.raises(LibError):
        tpricers.pv_float_leg(torch.ones(3), InterpTypes.FLAT_FWD_RATES,
                              {}, None)
    with pytest.raises(LibError):
        tx.bootstrap_xccy(torch.zeros(2), torch.zeros(2), torch.ones(3),
                          1.0, {"start_t": torch.zeros((2, 2))},
                          InterpTypes.FLAT_FWD_RATES, None)
