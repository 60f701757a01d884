"""Books on the fitted interpolation schemes, against adrates_tpu on the
CPU.

The all-kinds book of ``torch_cases`` (OIS, a basis swap, FRNs with clamp
slots, a bond, fix-float and fix-fix XCCY swaps, ZCIS and YoY; in USD,
tiled x2, 3 scenarios) on two scheme maps (``torch_cases.SPLINE_SCHEMES``)
that together cover the five fitted schemes: USD (the XCCY domestic
parent) NATCUBIC_ZERO_RATES, GBP (its foreign parent) PCHIP_LOG_DISCOUNT
and GBP_USD_XCCY PCHIP_ZERO_RATES, the XCCY curve recalibrated in-graph;
and USD PCHIP_ZERO_RATES, GBP NATCUBIC_LOG_DISCOUNT and GBP_USD_XCCY
FINCUBIC_ZERO_RATES, the XCCY curve held as values. The two OIS curves
have the same pillars and points, so no member of a stage is padded and
the JAX package's batched path fits every curve on its own knots.
Checked: the grids (against the JAX grids and each curve's ``df_t``),
the structured parts (J, the XCCY and OIS term 2), and pvs, delta and gamma on the structured, staged and generic
splits. The per-trade paths are in test_torch_splines_pertrade.py, the
single-trade engine in test_torch_splines_engine.py.

The padded fit: a 4-pillar PCHIP_LOG_DISCOUNT curve shares an OIS stage
with an 8-pillar FLAT_FWD curve, so it is padded there. The JAX package's
batched grids fit it on the padded grid and depart from its unbatched
ones by more than 1e-4 (ROADMAP C); the port fits it on its real knots,
and its grids, delta and gamma equal the JAX package's unbatched path and
the curve's ``df_t``.

Tolerance: 1e-10 x max|ref| throughout (the engine: of each output
kind)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import adrates_tpu  # noqa: F401 — enables x64 for the JAX side
import torch_cases as tc
from adrates_tpu.parallel import multibook as jmb
from adrates_tpu.parallel import structured_risk as jsr
from adrates_torch.parallel import multibook as tmb
from adrates_torch.parallel import structured_risk as tsr

SCHEMES = tc.SPLINE_SCHEMES


def _close(got, ref, tol=1e-10, msg=""):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, msg
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1e-300),
                               err_msg=msg)


@pytest.fixture(scope="module", params=list(SCHEMES))
def book(request):
    recal = request.param.endswith("recal")
    (jm, jb), (tm, tb) = (tc.spline_book(pkg, request.param)
                          for pkg in ("adrates_tpu", "adrates_torch"))
    q0 = jb.basket.quotes0
    sh = tc.shocks(jb.basket.n_quotes)
    ref = {k: np.asarray(v) for k, v in jmb.make_multibook_fn(jb)(
        jnp.asarray(q0), jnp.asarray(sh)).items()}
    return dict(name=request.param, jm=jm, tm=tm, jb=jb, tb=tb, q0=q0,
                sh=sh, ref=ref, recal=recal)


def test_spline_members_unpadded(book):
    """Every fitted member of a JAX stage is unpadded, so the JAX batched
    path is a valid reference, and the book holds all three fitted
    curves."""
    basket = book["jb"].basket
    bat = basket.params["bat"]
    fitted = 0
    for st in basket._stages:
        for g, cid in enumerate(st.ids):
            if basket.specs[cid].interp_type.name in SCHEMES[book["name"]] \
                    .values():
                fitted += 1
                assert not np.asarray(bat[st.key]["pad_mask"])[g].any()
    assert fitted == 3


def test_grids_match_jax_and_df_t(book):
    jb, tb, q0 = book["jb"], book["tb"], book["q0"]
    ref = np.asarray(jb.basket.grids(jnp.asarray(q0), jb.basket.params))
    got = tmb.make_multibook_fn(tb, "cpu").dfs_only(
        q0, np.zeros((1, q0.shape[0])))[0].numpy()
    _close(got, ref)
    basket = tb.basket
    for cid, spec in enumerate(basket.specs):
        cols = np.flatnonzero(basket.grid_curve_of == cid)
        t = basket.unique_times[basket.grid_local_of[cols]]
        _close(got[cols], book["tm"].curves[spec.name].df_t(t).numpy(),
               msg=spec.name)


@pytest.mark.parametrize("path", ["structured", "staged", "generic"])
def test_book_matches_jax(book, path):
    tb, q0, sh = book["tb"], book["q0"], book["sh"]
    if path == "structured":
        fn = tmb.make_multibook_fn(tb, "cpu")
        assert fn.structured
    elif path == "staged":
        fn = tmb.make_staged_multibook_fn(tb, "cpu")
    else:
        fn = tmb.make_multibook_fn(
            tc.spline_book("adrates_torch", book["name"],
                           batch_curves=False)[1], "cpu")
        assert not fn.structured
    got = fn(q0, sh)
    for k in ("pvs", "delta", "gamma"):
        _close(got[k], book["ref"][k], msg=k)


def test_structured_parts_match_jax(book):
    """fwd_delta's J and the XCCY and OIS term 2 of the structured split,
    per scenario (recalibrated, the XCCY term 2 owes the fitted parents
    cotangents; held, none)."""
    jb, tb, q0, sh = book["jb"], book["tb"], book["q0"], book["sh"]
    jp = jsr.make_structured_parts(jb.basket, host_agg=jb.aggregate)
    P, agg = jb.basket.params, jb.aggregate
    cl = jmb._agg_clamp(jax.device_put(jb.clamp), jb.tile)
    jfw = jax.jit(jax.vmap(lambda s: jp["fwd_delta"](q0 + s, P, agg,
                                                     cl)))(sh)
    jh2x, jv = jax.jit(jax.vmap(lambda s, g, c: jp["term2_xccy"](
        q0 + s, P, g, c)))(sh, jfw["g"], jfw["carry"])
    jh2o = jax.jit(jax.vmap(lambda s, g, v: jp["term2_ois"](
        q0 + s, P, g, v)))(sh, jfw["g"], jv)

    dev = tmb.make_multibook_fn(tb, "cpu").book
    tp = tsr.make_structured_parts(tmb.book_inputs(tb).topology)
    q = torch.tensor(q0[None, :] + sh)
    fw = tp["fwd_delta"](q, dev.params, dev.aggregate, dev.clamp_agg)
    h2x, v_of = tp["term2_xccy"](q, dev.params, fw["g"], fw["carry"])
    h2o = tp["term2_ois"](q, dev.params, fw["g"], v_of)
    _close(fw["J"], jfw["J"], msg="J")
    _close(h2x, jh2x, msg="term2_xccy")
    _close(h2o, jh2o, msg="term2_ois")
    assert bool(v_of) == book["recal"]


# ---------------------------------------------------------------------------
# a padded fitted member: the reference's batched fit departs


def _padded_model(pkg):
    u, Model, _ = tc._ns(pkg)
    D = u.DayCountTypes
    m = Model(u.Date(1, 1, 2024))
    m.build_curve("USD_OIS_SOFR",
                  px_list=[5.3, 5.0, 4.6, 4.3, 4.0, 3.95, 3.88, 3.8],
                  tenor_list=["6M", "1Y", "2Y", "3Y", "5Y", "7Y", "10Y",
                              "15Y"],
                  fixed_dcc_type=D.ACT_360, float_dc_type=D.ACT_360,
                  interp_type=u.InterpTypes.FLAT_FWD_RATES)
    m.build_curve("GBP_OIS_SONIA", px_list=[4.7, 4.3, 3.9, 3.87],
                  tenor_list=["1Y", "2Y", "5Y", "10Y"],
                  fixed_dcc_type=D.ACT_365F, float_dc_type=D.ACT_365F,
                  interp_type=u.InterpTypes.PCHIP_LOG_DISCOUNT)
    m.build_fx(["GBPUSD"], [1.27])
    return m


def _padded_trades(pkg, model):
    u, _, OIS = tc._ns(pkg)
    v = model.value_dt
    D, F, C, S, Y = (u.DayCountTypes, u.FrequencyTypes, u.CurveTypes,
                     u.SwapTypes, u.CurrencyTypes)
    return [OIS(v.add_months(3), ten, S.RECEIVE, 0.04, F.ANNUAL, D.ACT_365F,
                C.GBP_OIS_SONIA, Y.GBP, notional=1e7,
                float_dc_type=D.ACT_365F)
            for ten in ("3Y", "8Y", "12Y")] + \
        [OIS(v, "7Y", S.PAY, 0.041, F.ANNUAL, D.ACT_360, C.USD_OIS_SOFR,
             Y.USD, notional=8e6, float_dc_type=D.ACT_360)]


@pytest.fixture(scope="module")
def padded():
    out = {}
    for pkg in ("adrates_tpu", "adrates_torch"):
        m = _padded_model(pkg)
        mod = importlib.import_module(f"{pkg}.parallel.multibook")
        trades = _padded_trades(pkg, m)
        out[pkg] = dict(m=m, books={
            batch: mod.compile_multibook(
                trades, m, base_currency=mod.CurrencyTypes.USD,
                batch_curves=batch)
            for batch in ((True, False) if pkg == "adrates_tpu"
                          else (True,))})
    return out


def test_padded_spline_member_departs_in_the_reference(padded):
    jb = padded["adrates_tpu"]["books"]
    q0 = jb[True].basket.quotes0
    st = jb[True].basket._stages[0]
    gbp = jb[True].basket.curve_id("GBP_OIS_SONIA")
    assert st.kind == "ois" and len(st.ids) == 2
    assert np.asarray(jb[True].basket.params["bat"][st.key]["pad_mask"])[
        st.ids.index(gbp)].any()
    grids = {b: np.asarray(mb.basket.grids(jnp.asarray(q0),
                                           mb.basket.params))
             for b, mb in jb.items()}
    assert np.abs(grids[True] - grids[False]).max() > 1e-4


def test_padded_spline_member_fits_its_real_knots(padded):
    jb = padded["adrates_tpu"]["books"][False]
    tb = padded["adrates_torch"]["books"][True]
    q0 = tb.basket.quotes0
    sh = tc.shocks(q0.shape[0], 2)
    ref = np.asarray(jb.basket.grids(jnp.asarray(q0), jb.basket.params))
    fn = tmb.make_multibook_fn(tb, "cpu")
    assert fn.structured
    got = fn.dfs_only(q0, np.zeros((1, q0.shape[0])))[0].numpy()
    _close(got, ref, msg="grids")
    basket = tb.basket
    gbp = basket.curve_id("GBP_OIS_SONIA")
    cols = np.flatnonzero(basket.grid_curve_of == gbp)
    t = basket.unique_times[basket.grid_local_of[cols]]
    assert t.max() > 10.5                     # queries past the last pillar
    _close(got[cols], padded["adrates_torch"]["m"].curves["GBP_OIS_SONIA"]
           .df_t(t).numpy(), msg="df_t")
    jref = jmb.make_multibook_fn(jb)(jnp.asarray(q0), jnp.asarray(sh))
    out = fn(q0, sh)
    for k in ("delta", "gamma"):
        _close(out[k], jref[k], msg=k)


