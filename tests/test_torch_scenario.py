"""The port's ``Model.scenario`` and ``Model.scenario_grid`` against the
JAX package's, on the CPU, on the quick start's model (GBP and USD OIS,
the GBP/USD basis curve over both, GBP RPI inflation): the shocked curve's
DFs and its XCCY dependants' under float and dict shocks (1e-12), what is
copied by reference, the errors (unknown curve or tenor: ``LibError``; an
XCCY or inflation curve's name: ``KeyError``, as in the JAX package),
``scenario_grid`` [S, N] (1e-12) and its rows against ``scenario``; then
the engine's delta against central FDs of VALUE on scenario models, the
checks of ``tests/test_ois_requests.py`` (parallel, per tenor, Taylor
P&L) and ``tests/test_marketdata.py`` (an OIS under USD collateral, whose
XCCY curve the scenario rebuilds)."""

import numpy as np
import pytest
import torch

import torch_cases as tc
from adrates_tpu.utils import LibError as JLibError
from adrates_torch.models import Model
from adrates_torch.trades.rates import OIS
from adrates_torch.utils import (BusDayAdjustTypes, CollateralType,
                                 CurrencyTypes, CurveTypes, Date,
                                 DayCountTypes, FrequencyTypes, InterpTypes,
                                 LibError, RequestTypes, SwapTypes)

PKGS = ("adrates_tpu", "adrates_torch")
VALUE_DT = Date(1, 1, 2024)
SHOCKS = [1.0, -0.35, {"5Y": 0.01}, {"1Y": 0.2, "10Y": -0.05, "30Y": 0.03}]
SHOCK_IDS = ["parallel+100bp", "parallel-35bp", "5Y+1bp", "three_tenors"]


@pytest.fixture(scope="module")
def models():
    return {pkg: tc.quickstart_model(pkg)[0] for pkg in PKGS}


def _dfs(model, name) -> np.ndarray:
    d = model.curves[name]._dfs
    return d.numpy() if isinstance(d, torch.Tensor) else np.asarray(d)


def _close(got, ref, atol=1e-12):
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)


@pytest.mark.parametrize("shock", SHOCKS, ids=SHOCK_IDS)
@pytest.mark.parametrize("curve", ["GBP_OIS_SONIA", "USD_OIS_SOFR"])
def test_scenario_matches_jax(models, curve, shock):
    got = models["adrates_torch"].scenario(curve, shock)
    ref = models["adrates_tpu"].scenario(curve, shock)
    assert list(got.curves.keys()) == list(ref.curves.keys())
    # the shocked curve and its XCCY dependant (GBP is its foreign
    # parent, USD its domestic one) are rebuilt, and equal JAX's
    for name in (curve, "GBP_USD_BASIS"):
        _close(_dfs(got, name), _dfs(ref, name))
        assert not np.array_equal(_dfs(got, name),
                                  _dfs(models["adrates_torch"], name))
    assert got._curve_params_dict[curve]["px_list"] == \
        ref._curve_params_dict[curve]["px_list"]


def test_scenario_copies_the_rest_by_reference(models):
    for pkg in PKGS:
        m = models[pkg]
        s = m.scenario("GBP_OIS_SONIA", 0.5)
        assert s.curves["USD_OIS_SOFR"] is m.curves["USD_OIS_SOFR"]
        assert s.curves["GBP_RPI_INFLATION"] is \
            m.curves["GBP_RPI_INFLATION"]
        assert s.curves["GBP_OIS_SONIA"] is not m.curves["GBP_OIS_SONIA"]
        assert s._fx_params_dict == m._fx_params_dict
        assert s._fx_params_dict is not m._fx_params_dict
        assert s.value_dt == m.value_dt


@pytest.mark.parametrize("args,match", [
    (("EUR_OIS_ESTR", 1.0), "No stored parameters"),
    (("GBP_OIS_SONIA", {"4Y": 0.01}), "Shock tenors not on curve"),
])
def test_scenario_errors(models, args, match):
    with pytest.raises(LibError, match=match):
        models["adrates_torch"].scenario(*args)
    with pytest.raises(JLibError, match=match):
        models["adrates_tpu"].scenario(*args)


@pytest.mark.parametrize("name", ["GBP_USD_BASIS", "GBP_RPI_INFLATION"])
def test_scenario_on_a_curve_without_px_list(models, name):
    """Reproduced from the JAX package: an XCCY or inflation curve's
    stored parameters have no ``px_list``, so ``scenario`` raises
    ``KeyError`` (not ``LibError``) on its name."""
    for pkg in PKGS:
        with pytest.raises(KeyError, match="px_list"):
            models[pkg].scenario(name, 0.01)


def test_scenario_grid_matches_jax(models):
    shocks = np.random.default_rng(7).normal(0.0, 0.1, (5, 13))
    got = models["adrates_torch"].scenario_grid("GBP_OIS_SONIA", shocks,
                                                device="cpu")
    ref = np.asarray(models["adrates_tpu"].scenario_grid("GBP_OIS_SONIA",
                                                         shocks))
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    _close(got.numpy(), ref)


def test_scenario_grid_rows_equal_scenario(models):
    m = models["adrates_torch"]
    tenors = m._curve_params_dict["GBP_OIS_SONIA"]["tenor_list"]
    shocks = np.random.default_rng(7).normal(0.0, 0.1, (3, len(tenors)))
    grid = m.scenario_grid("GBP_OIS_SONIA", torch.from_numpy(shocks),
                           device="cpu").numpy()
    for row, shock in zip(grid, shocks):
        s = m.scenario("GBP_OIS_SONIA", dict(zip(tenors, shock)))
        _close(row, _dfs(s, "GBP_OIS_SONIA"))


def test_scenario_grid_device_rule(models):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: None selects it")
    with pytest.raises(LibError, match="device='cpu'"):
        models["adrates_torch"].scenario_grid("GBP_OIS_SONIA",
                                              np.zeros((1, 13)))


# ---------------------------------------------------------------------------
# The engine's delta against central FDs on scenario models
# ---------------------------------------------------------------------------

SONIA_TENORS = ["1M", "2M", "3M", "4M", "5M", "6M", "7M", "8M", "9M", "10M",
                "11M", "1Y", "18M", "2Y", "3Y", "4Y", "5Y", "6Y", "7Y", "8Y",
                "9Y", "10Y", "12Y", "15Y", "20Y", "25Y", "30Y", "35Y", "40Y",
                "45Y", "50Y", "60Y"]
SONIA_RATES = [5.19, 5.17, 5.15, 5.12, 5.09, 5.04, 4.98, 4.92, 4.87, 4.81,
               4.76, 4.71, 4.51, 4.35, 4.13, 4.00, 3.93, 3.89, 3.87, 3.86,
               3.86, 3.87, 3.89, 3.91, 3.88, 3.80, 3.71, 3.61, 3.51, 3.42,
               3.33, 3.21]


@pytest.fixture(scope="module")
def sonia():
    """The 32-pillar SONIA model of tests/test_ois_requests.py, the 10Y
    RECEIVE 3.87% OIS and its VALUE / DELTA / GAMMA on the CPU."""
    m = Model(VALUE_DT)
    m.build_curve("GBP_OIS_SONIA", px_list=SONIA_RATES,
                  tenor_list=SONIA_TENORS,
                  fixed_dcc_type=DayCountTypes.ACT_365F,
                  float_dc_type=DayCountTypes.ACT_365F,
                  bus_day_type=BusDayAdjustTypes.MODIFIED_FOLLOWING,
                  interp_type=InterpTypes.LINEAR_ZERO_RATES)
    swap = OIS(VALUE_DT, "10Y", SwapTypes.RECEIVE, 0.0387,
               FrequencyTypes.ANNUAL, DayCountTypes.ACT_365F,
               CurveTypes.GBP_OIS_SONIA, CurrencyTypes.GBP,
               notional=10_000_000, float_dc_type=DayCountTypes.ACT_365F,
               bd_type=BusDayAdjustTypes.MODIFIED_FOLLOWING)
    res = swap.position(m, device="cpu").compute(
        [RequestTypes.VALUE, RequestTypes.DELTA, RequestTypes.GAMMA])
    return m, swap, res


def _reval(model, swap, shock):
    shocked = model.scenario("GBP_OIS_SONIA", shock)
    return swap.value(VALUE_DT, shocked.curves.GBP_OIS_SONIA)


def test_parallel_delta_vs_scenario_fd(sonia):
    m, swap, res = sonia
    fd = (_reval(m, swap, 0.01) - _reval(m, swap, -0.01)) / 2
    ad = float(np.sum(res.risk.risk_ladder))
    assert abs(ad - fd) / abs(fd) < 1e-4


@pytest.mark.parametrize("tenor", ["2Y", "5Y", "10Y"])
def test_tenor_delta_vs_scenario_fd(sonia, tenor):
    m, swap, res = sonia
    fd = (_reval(m, swap, {tenor: 0.01})
          - _reval(m, swap, {tenor: -0.01})) / 2
    ad = float(res.risk.risk_ladder[SONIA_TENORS.index(tenor)])
    if abs(fd) > 1e-4:
        assert abs(ad - fd) / abs(fd) < 0.05


@pytest.mark.parametrize("shock_bp", [100, 200])
def test_taylor_pnl_by_scenario(sonia, shock_bp):
    m, swap, res = sonia
    base = swap.value(VALUE_DT, m.curves.GBP_OIS_SONIA)
    pnl = _reval(m, swap, shock_bp / 100.0) - base
    order1 = float(np.sum(res.risk.risk_ladder)) * shock_bp
    order2 = order1 + 0.5 * float(np.sum(res.gamma.risk_ladder)) \
        * shock_bp ** 2
    assert abs(order2 - pnl) <= abs(order1 - pnl) * 0.5
    assert abs(order2 - pnl) / abs(pnl) < 0.05


def test_collateral_ois_delta_vs_scenario_fd():
    """The OIS-rate ladder of an OIS under USD collateral carries the
    XCCY recalibration chain: it matches a central FD on scenario models,
    which rebuild the dependent XCCY curve."""
    m = Model(VALUE_DT)
    m.build_curve("USD_OIS_SOFR", px_list=[5.3, 5.0, 4.6, 4.0, 3.88],
                  tenor_list=["6M", "1Y", "2Y", "5Y", "10Y"],
                  fixed_dcc_type=DayCountTypes.ACT_360,
                  float_dc_type=DayCountTypes.ACT_360,
                  interp_type=InterpTypes.FLAT_FWD_RATES)
    m.build_curve("GBP_OIS_SONIA", px_list=[5.0, 4.7, 4.3, 3.9, 3.87],
                  tenor_list=["6M", "1Y", "2Y", "5Y", "10Y"],
                  fixed_dcc_type=DayCountTypes.ACT_365F,
                  float_dc_type=DayCountTypes.ACT_365F,
                  interp_type=InterpTypes.FLAT_FWD_RATES)
    m.build_xccy_curve(name="GBP_USD_XCCY",
                       domestic_curve_name="USD_OIS_SOFR",
                       foreign_curve_name="GBP_OIS_SONIA",
                       basis_spreads=[-5.0, -8.0, -11.0],
                       tenor_list=["1Y", "5Y", "10Y"], spot_fx=1.27)
    m.build_fx(["GBPUSD"], [1.27])
    s = OIS(VALUE_DT, "5Y", SwapTypes.RECEIVE, 0.039, FrequencyTypes.ANNUAL,
            DayCountTypes.ACT_365F, CurveTypes.GBP_OIS_SONIA,
            CurrencyTypes.GBP, notional=10_000_000,
            float_dc_type=DayCountTypes.ACT_365F)

    def value(model):
        return s.position(model, device="cpu").compute(
            [RequestTypes.VALUE],
            collateral_type=CollateralType.USD).value.amount

    res = s.position(m, device="cpu").compute(
        [RequestTypes.DELTA], collateral_type=CollateralType.USD)
    ladder = res.risk(CurveTypes.GBP_OIS_SONIA).risk_ladder
    h_pct = 0.01                    # percent units for scenario(); 1 bp
    fd = (value(m.scenario("GBP_OIS_SONIA", {"5Y": h_pct}))
          - value(m.scenario("GBP_OIS_SONIA", {"5Y": -h_pct}))) \
        / (2 * h_pct * 100)
    assert ladder[3] == pytest.approx(fd, rel=5e-4, abs=1e-2)
