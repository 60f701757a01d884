"""The single-trade engine on the fitted interpolation schemes, against
adrates_tpu on the CPU: every route of ``torch_cases.ENGINE_ROUTES`` plus
a GBP OIS on its natural curve and under USD collateral, on the
all-kinds model with USD on NATCUBIC_ZERO_RATES, GBP on
PCHIP_LOG_DISCOUNT and GBP_USD_XCCY on PCHIP_ZERO_RATES: PV, every
ladder, gamma block and cross-gamma and the cashflows at 1e-10 x
max|ref| of their kind; and the engine's PVs against the port's book.
"""

import importlib

import numpy as np
import pytest

import adrates_tpu  # noqa: F401 — enables x64 for the JAX side
import torch_cases as tc
from adrates_torch.parallel import multibook as tmb

ENGINE_ROUTES = ["ois", "ois_usd_collateral"] + tc.ENGINE_ROUTES


@pytest.fixture(scope="module")
def engine_models():
    return {pkg: tc.build_all_kinds_model(pkg, tc.SPLINE_SCHEMES["a_recal"])
            for pkg in ("adrates_tpu", "adrates_torch")}


@pytest.fixture(scope="module", params=ENGINE_ROUTES)
def route(request, engine_models):
    name = request.param
    if not name.startswith("ois"):
        return tc.engine_route_results(engine_models, name)
    out = dict(name=name)
    for pkg, key in (("adrates_tpu", "jax"), ("adrates_torch", "port")):
        u = importlib.import_module(f"{pkg}.utils")
        R = u.RequestTypes
        model = engine_models[pkg]
        trade = tc.all_kinds_trades(pkg, model)[0]        # GBP 5Y OIS
        if name == "ois":
            reqs, coll = [R.VALUE, R.DELTA, R.GAMMA, R.CASHFLOWS], None
        else:
            reqs, coll = [R.VALUE, R.DELTA, R.GAMMA], u.CollateralType.USD
        kw = {} if pkg == "adrates_tpu" else dict(device="cpu")
        out[key] = trade.position(model, **kw).compute(reqs, coll)
    out["jp"] = tc.result_parts(out["jax"])
    out["tp"] = tc.result_parts(out["port"])
    return out


@pytest.mark.parametrize("kind", ["value", "delta", "gamma", "cashflows"])
def test_engine_route_matches_jax(route, kind):
    jp, tp = route["jp"], route["tp"]
    assert (kind in jp) == (kind in tp)
    if kind in jp:
        tc.assert_parts_close({kind: jp[kind]}, {kind: tp[kind]})


def test_engine_matches_book_pvs(engine_models):
    """The engine's PV of each route trade on the fitted curves equals the
    book's PV of the same trade (the port's batched book, structured
    split) at 1e-10."""
    from adrates_torch.utils import CurrencyTypes, RequestTypes
    m = engine_models["adrates_torch"]
    trades = tc.all_kinds_trades("adrates_torch", m)
    mb = tmb.compile_multibook(trades, m, base_currency=CurrencyTypes.GBP)
    q0 = mb.basket.quotes0
    pvs = tmb.make_multibook_fn(mb, "cpu").pvs_only(
        q0, np.zeros((1, q0.shape[0])))[0].numpy()
    for k, t in enumerate(trades):
        res = t.position(m, device="cpu").compute([RequestTypes.VALUE])
        ccy = res.value.currency.name
        fx = 1.0 if ccy == "GBP" else m.fx(f"GBP{ccy}")
        assert pvs[k] == pytest.approx(res.value.amount / fx,
                                       rel=1e-10, abs=1e-6), k
