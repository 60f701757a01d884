"""The port's single-trade engine on the OIS against the JAX package's, on
the CPU, plus the engine's contract: ``position(model).compute`` with
VALUE, DELTA, GAMMA, SPEED and CASHFLOWS on an OIS under natural
collateral, and VALUE, DELTA, GAMMA under foreign collateral (projected
on its OIS curve, discounted on an XCCY curve: the chained case, where
the XCCY curve's foreign curve is the trade's own, and the unrelated
case), each equal to the JAX engine's at 1e-10 x max|ref| of its kind;
the reference-parity constants of ``tests/test_reference_parity.py`` on
the port's 13-pillar model; ``Portfolio`` sums; one device->host copy
per request; and the device rule (no device and no card raises)."""

import importlib

import numpy as np
import pytest
import torch

import torch_cases as tc

PKGS = ("adrates_tpu", "adrates_torch")
ROUTES = ["ois_natural", "ois_seasoned", "ois_coll_chained",
          "ois_coll_unrelated"]


def _route(pkg, model, name):
    """(trade, requests, collateral type) of an OIS route on
    build_credit_model."""
    u = importlib.import_module(f"{pkg}.utils")
    R = u.RequestTypes
    OIS = importlib.import_module(f"{pkg}.trades.rates").OIS
    v = model.value_dt
    D, F, C, S, Y = (u.DayCountTypes, u.FrequencyTypes, u.CurveTypes,
                     u.SwapTypes, u.CurrencyTypes)
    MF = u.BusDayAdjustTypes.MODIFIED_FOLLOWING
    full = [R.VALUE, R.DELTA, R.GAMMA, R.SPEED, R.CASHFLOWS]
    risk = [R.VALUE, R.DELTA, R.GAMMA]
    risk_cf = risk + [R.CASHFLOWS]
    if name == "ois_natural":
        return OIS(v, "5Y", S.RECEIVE, 0.039, F.ANNUAL, D.ACT_365F,
                   C.GBP_OIS_SONIA, Y.GBP, notional=10_000_000,
                   float_dc_type=D.ACT_365F, bd_type=MF), full, None
    if name == "ois_seasoned":
        return OIS(v.add_months(-7), "3Y", S.PAY, 0.045, F.QUARTERLY,
                   D.ACT_360, C.USD_OIS_SOFR, Y.USD, notional=15_000_000,
                   float_dc_type=D.ACT_360, payment_lag=1,
                   bd_type=MF), risk_cf, None
    if name == "ois_coll_chained":
        return OIS(v.add_months(-7), "7Y", S.PAY, 0.041, F.ANNUAL,
                   D.ACT_365F, C.GBP_OIS_SONIA, Y.GBP, notional=8e6,
                   float_dc_type=D.ACT_365F, bd_type=MF), risk, \
            u.CollateralType.USD
    return OIS(v.add_months(2), "4Y", S.RECEIVE, 0.043, F.SEMI_ANNUAL,
               D.ACT_360, C.USD_OIS_SOFR, Y.USD, notional=6e6,
               float_dc_type=D.ACT_360, bd_type=MF), risk, \
        u.CollateralType.GBP


@pytest.fixture(scope="module")
def models():
    return {pkg: tc.build_credit_model(pkg) for pkg in PKGS}


@pytest.fixture(scope="module", params=ROUTES)
def route(request, models):
    out = dict(name=request.param)
    for pkg, key in zip(PKGS, ("jax", "port")):
        model = models[pkg]
        if request.param == "ois_coll_unrelated":
            # a fresh model: the JAX engine caches the first collateral
            # request's OIS bootstrap plan on the XCCY curve and reuses it
            # for a trade on another OIS curve (the port keys its device
            # constants by curve)
            model = tc.build_credit_model(pkg)
        trade, reqs, coll = _route(pkg, model, request.param)
        kw = {} if pkg == "adrates_tpu" else dict(device="cpu")
        out[key] = trade.position(model, **kw).compute(reqs, coll)
    out["jp"] = tc.result_parts(out["jax"])
    out["tp"] = tc.result_parts(out["port"])
    return out


@pytest.mark.parametrize("kind", ["value", "delta", "gamma", "speed",
                                  "cashflows"])
def test_ois_matches_jax(route, kind):
    jp, tp = route["jp"], route["tp"]
    assert (kind in jp) == (kind in tp)
    if kind not in jp:
        # SPEED is asked of the first route only, CASHFLOWS of the
        # natural-collateral ones: the foreign-collateral route reports
        # neither
        assert route["name"] != "ois_natural"
        assert kind == "speed" or route["name"].startswith("ois_coll")
        return
    tc.assert_parts_close({kind: jp[kind]}, {kind: tp[kind]})


def test_ois_labels_match_jax(route):
    assert tc.result_labels(route["port"]) == tc.result_labels(route["jax"])


def test_ois_gamma_symmetric(route):
    tc.check_gamma_symmetric(route["tp"])


def test_speed_cube_fully_symmetric(route):
    if "speed" not in route["tp"]:
        assert route["name"] != "ois_natural"
        return
    (cube,) = route["tp"]["speed"].values()
    tol = 1e-9 * np.abs(cube).max()
    for perm in ((1, 0, 2), (0, 2, 1), (2, 1, 0)):
        np.testing.assert_allclose(cube, np.transpose(cube, perm), rtol=0,
                                   atol=tol)


@pytest.mark.parametrize("name", ROUTES)
def test_ois_pv_equals_direct_value(models, name):
    from adrates_torch.trades.rates.xccy_curve import XccyCurve
    from adrates_torch.utils import (RequestTypes, collateral_to_currency)
    model = models["adrates_torch"]
    trade, _, coll = _route("adrates_torch", model, name)
    res = trade.position(model, device="cpu").compute(
        [RequestTypes.VALUE], coll)
    ois = model.curves[trade._floating_index.name]
    if coll is None:
        direct = trade.value(model.value_dt, ois)
    else:
        xc = next(c for c in model._curves_dict.values()
                  if isinstance(c, XccyCurve))
        ccy = collateral_to_currency(coll)
        fx = model.fx(f"{ccy.name}{trade._currency.name}")
        direct = trade.value(model.value_dt, ois, xccy_discount_curve=xc,
                             spot_fx=fx, collateral_type=coll)
    assert res.value.amount == pytest.approx(
        direct, abs=max(1e-6, 1e-12 * abs(direct)))


def test_one_host_copy_per_request(models, monkeypatch):
    """Every route packs its outputs into one device tensor and copies it
    to the host once."""
    from adrates_torch.market.position.engine import Engine
    calls = []
    orig = Engine._unpack

    def counted(packed, sizes):
        calls.append(len(sizes))
        return orig(packed, sizes)
    monkeypatch.setattr(Engine, "_unpack", staticmethod(counted))
    model = models["adrates_torch"]
    for name in ROUTES:
        trade, reqs, coll = _route("adrates_torch", model, name)
        calls.clear()
        trade.position(model, device="cpu").compute(reqs, coll)
        assert len(calls) == 1, name


def test_single_measure_wrappers(models):
    from adrates_torch.market import Engine
    from adrates_torch.utils import RequestTypes
    model = models["adrates_torch"]
    trade, _, _ = _route("adrates_torch", model, "ois_natural")
    eng = Engine(model, device="cpu")
    full = eng.compute(trade, [RequestTypes.VALUE, RequestTypes.DELTA,
                               RequestTypes.GAMMA])
    assert eng.valuation(trade).amount == full.value.amount
    np.testing.assert_array_equal(eng.delta(trade).risk_ladder,
                                  full.risk.risk_ladder)
    np.testing.assert_array_equal(eng.gamma(trade).risk_ladder,
                                  full.gamma.risk_ladder)
    only_cf = eng.compute(trade, [RequestTypes.CASHFLOWS])
    assert only_cf.value is None and len(only_cf.cashflows) > 0


# ---------------------------------------------------------------------------
# the device rule


def test_no_device_and_no_card_raises(models, monkeypatch):
    from adrates_torch.market import Engine, Position
    from adrates_torch.utils.error import LibError
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = models["adrates_torch"]
    trade, _, _ = _route("adrates_torch", model, "ois_natural")
    with pytest.raises(LibError, match="no CUDA device"):
        Engine(model)
    with pytest.raises(LibError, match="no CUDA device"):
        Position(trade, model)
    with pytest.raises(LibError, match="no CUDA device"):
        trade.position(model)


def test_no_device_means_the_card(models, monkeypatch):
    """With a card visible, None is the CUDA device (nothing is placed on
    it until a request runs)."""
    from adrates_torch.market import Engine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    model = models["adrates_torch"]
    trade, _, _ = _route("adrates_torch", model, "ois_natural")
    assert Engine(model).device == torch.device("cuda")
    assert trade.position(model).device == torch.device("cuda")
    assert trade.position(model, device="cpu").device == torch.device("cpu")


# ---------------------------------------------------------------------------
# Portfolio


def _portfolio(pkg, model, kw):
    u = importlib.import_module(f"{pkg}.utils")
    OIS = importlib.import_module(f"{pkg}.trades.rates").OIS
    Portfolio = importlib.import_module(f"{pkg}.market").Portfolio
    v = model.value_dt
    # three 5Y annual swaps (one payment count, so the JAX package
    # compiles one request shape for all three)
    swaps = [OIS(st, "5Y", side, cpn, u.FrequencyTypes.ANNUAL,
                 u.DayCountTypes.ACT_365F, u.CurveTypes.GBP_OIS_SONIA,
                 u.CurrencyTypes.GBP, notional=nt,
                 float_dc_type=u.DayCountTypes.ACT_365F)
             for st, side, cpn, nt in (
                 (v, u.SwapTypes.PAY, 0.04, 1e6),
                 (v.add_months(3), u.SwapTypes.RECEIVE, 0.038, 2.5e6),
                 (v.add_months(-2), u.SwapTypes.PAY, 0.039, 4e6))]
    return swaps, Portfolio([s.position(model, **kw) for s in swaps])


@pytest.fixture(scope="module")
def portfolios(models):
    from adrates_torch.utils import RequestTypes as R
    reqs = [R.VALUE, R.DELTA, R.GAMMA]
    out = {}
    for pkg in PKGS:
        kw = {} if pkg == "adrates_tpu" else dict(device="cpu")
        swaps, pf = _portfolio(pkg, models[pkg], kw)
        u = importlib.import_module(f"{pkg}.utils")
        r = [u.RequestTypes[x.name] for x in reqs]
        out[pkg] = dict(swaps=swaps, pf=pf, res=pf.compute(r),
                        each=[s.position(models[pkg], **kw).compute(r)
                              for s in swaps])
    return out


@pytest.mark.parametrize("kind", ["value", "delta", "gamma"])
def test_portfolio_matches_jax(portfolios, kind):
    jp = tc.result_parts(portfolios["adrates_tpu"]["res"])
    tp = tc.result_parts(portfolios["adrates_torch"]["res"])
    tc.assert_parts_close({kind: jp[kind]}, {kind: tp[kind]})


def test_portfolio_is_the_sum_of_its_positions(portfolios):
    p = portfolios["adrates_torch"]
    res, each = p["res"], p["each"]
    assert res.value.amount == pytest.approx(
        sum(r.value.amount for r in each), abs=1e-9)
    np.testing.assert_allclose(
        res.risk.risk_ladder, sum(r.risk.risk_ladder for r in each),
        rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        res.gamma.risk_ladder, sum(r.gamma.risk_ladder for r in each),
        rtol=0, atol=1e-12)
    assert len(p["pf"]) == 3 and "3 positions" in repr(p["pf"])


def test_portfolio_rejects_mixed_currencies(models):
    from adrates_torch.market import Portfolio
    from adrates_torch.utils import RequestTypes
    model = models["adrates_torch"]
    gbp, _, _ = _route("adrates_torch", model, "ois_natural")
    usd, _, _ = _route("adrates_torch", model, "ois_seasoned")
    pf = Portfolio()
    pf.add(gbp.position(model, device="cpu"))
    pf.add_position(usd.position(model, device="cpu"))
    with pytest.raises(ValueError, match="Cannot add"):
        pf.compute([RequestTypes.VALUE])


# ---------------------------------------------------------------------------
# tests/test_reference_parity.py's engine constants on the port


def test_reference_parity_10y_engine():
    from adrates_torch.models import Model
    from adrates_torch.trades.rates import OIS
    from adrates_torch.utils import (BusDayAdjustTypes, CurrencyTypes,
                                     CurveTypes, Date, DayCountTypes,
                                     FrequencyTypes, RequestTypes, SwapTypes)
    from test_reference_parity import (RATES, REF_10Y_DELTA_10Y_BUCKET,
                                       REF_4Y_QUARTERLY_DIRECT, TENORS)
    v = Date(1, 1, 2024)
    m = Model(v)
    m.build_curve("GBP_OIS_SONIA", px_list=RATES, tenor_list=TENORS,
                  fixed_dcc_type=DayCountTypes.ACT_365F,
                  float_dc_type=DayCountTypes.ACT_365F)
    swap = OIS(v, "10Y", SwapTypes.RECEIVE, 0.0387, FrequencyTypes.ANNUAL,
               DayCountTypes.ACT_365F, CurveTypes.GBP_OIS_SONIA,
               CurrencyTypes.GBP, notional=10_000_000,
               float_dc_type=DayCountTypes.ACT_365F,
               bd_type=BusDayAdjustTypes.MODIFIED_FOLLOWING)
    res = swap.position(m, device="cpu").compute(
        [RequestTypes.VALUE, RequestTypes.DELTA, RequestTypes.GAMMA])
    assert abs(res.value.amount) < 1e-6
    i = TENORS.index("10Y")
    assert res.risk.risk_ladder[i] == pytest.approx(REF_10Y_DELTA_10Y_BUCKET,
                                                    rel=1e-3)
    assert res.gamma.risk_ladder[i, i] == pytest.approx(2.896652, rel=1e-4)
    mask = np.ones(len(TENORS), dtype=bool)
    mask[i] = False
    assert np.max(np.abs(res.risk.risk_ladder[mask])) < 1e-6

    q4 = OIS(v, "4Y", SwapTypes.PAY, 0.0425, FrequencyTypes.QUARTERLY,
             DayCountTypes.ACT_365F, CurveTypes.GBP_OIS_SONIA,
             CurrencyTypes.GBP, notional=25_000_000,
             float_freq_type=FrequencyTypes.QUARTERLY,
             float_dc_type=DayCountTypes.ACT_365F,
             bd_type=BusDayAdjustTypes.MODIFIED_FOLLOWING)
    engine = q4.position(m, device="cpu").compute(
        [RequestTypes.VALUE]).value.amount
    assert engine == pytest.approx(REF_4Y_QUARTERLY_DIRECT, abs=2e-7)
