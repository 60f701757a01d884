"""The port's single-trade engine on the XCCY routes against the JAX
package's, on the CPU: a float/float basis swap, a fix-float and a
fix-fix swap on ``torch_cases.build_all_kinds_model`` (GBP_USD_XCCY over
the USD and GBP OIS curves). Both packages build the same model and
trade from the same quotes and answer VALUE + DELTA + GAMMA +
CASHFLOWS; the PV, the domestic, foreign and basis ladders, their gamma
matrices, the foreign x basis cross-gamma and the cashflow amounts agree
at 1e-10 x max|ref| of their kind, and the labels (currencies, curve
types, tenors, dates, leg tags) exactly. The other kinds' routes are in
test_torch_engine_kinds.py, the OIS in test_torch_engine.py."""

import pytest

import torch_cases as tc

ROUTES = ["xccy_basis", "xccy_fix_float", "xccy_fix_fix"]


@pytest.fixture(scope="module")
def models():
    return {pkg: tc.build_all_kinds_model(pkg)
            for pkg in ("adrates_tpu", "adrates_torch")}


@pytest.fixture(scope="module", params=ROUTES)
def route(request, models):
    return tc.engine_route_results(models, request.param)


@pytest.mark.parametrize("kind", ["value", "delta", "gamma", "cashflows"])
def test_route_matches_jax(route, kind):
    tc.check_route_kind(route, kind)


def test_route_labels_match_jax(route):
    assert tc.result_labels(route["port"]) == tc.result_labels(route["jax"])


def test_route_gamma_blocks_symmetric(route):
    tc.check_gamma_symmetric(route["tp"])


@pytest.mark.parametrize("name", ROUTES)
def test_route_pv_equals_direct_value(models, name):
    """Engine PV == the trade's own host ``value(...)`` on the port's
    curves, at abs 1e-6 (the JAX package's gate) or rel 1e-12."""
    from adrates_torch.utils import RequestTypes
    model = models["adrates_torch"]
    trade, _ = tc.engine_route("adrates_torch", model, name)
    res = trade.position(model, device="cpu").compute([RequestTypes.VALUE])
    direct = tc.direct_value(model, trade)
    assert res.value.amount == pytest.approx(
        direct, abs=max(1e-6, 1e-12 * abs(direct)))


def test_foreign_curve_rebuilt_after_the_xccy_curve():
    """A foreign OIS curve rebuilt (same quotes, a new object) after its
    XCCY curve: the basis bootstrap takes a static plan on the new
    curve's grid, and the basis swap's risk is unchanged."""
    from adrates_torch.utils import RequestTypes as R
    model = tc.build_all_kinds_model("adrates_torch")
    reqs = [R.VALUE, R.DELTA, R.GAMMA]
    trade, _ = tc.engine_route("adrates_torch", model, "xccy_basis")
    before = tc.result_parts(trade.position(model, device="cpu")
                             .compute(reqs))
    old = model.curves["GBP_OIS_SONIA"]
    model.build_curve("GBP_OIS_SONIA",
                      **model._curve_params_dict["GBP_OIS_SONIA"])
    assert model.curves["GBP_OIS_SONIA"] is not old
    assert model.curves["GBP_USD_XCCY"]._foreign_curve is old
    after = tc.result_parts(trade.position(model, device="cpu")
                            .compute(reqs))
    tc.assert_parts_close(before, after, rel=0.0)
