"""The port's single-trade engine on the inflation and credit routes
against the JAX package's, on the CPU: a ZCIS and a YoY swap (discount x
breakeven risk), a bullet and an amortizing bond, a plain, a capped and
floored and a dual-curve FRN (a USD note projected on GBP SONIA), on
``torch_cases.build_all_kinds_model``. Both packages answer the same
request; the PV, every ladder, gamma matrix and cross-gamma, and the
cashflow amounts agree at 1e-10 x max|ref| of their kind, and the labels
exactly."""

import pytest

import torch_cases as tc

ROUTES = ["zcis", "yoy", "bond", "bond_amortizing", "frn", "frn_capped",
          "frn_dual"]


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
