"""The port's model persistence (``Model.to_json`` / ``from_json``,
``adrates_torch/models/serialization.py``) against the JAX package's, on
the CPU: the port's round trip rebuilds every curve bit for bit; the two
packages store the same parameter keys and write the same JSON text; a
JSON written by either package loads in the other with every curve's
DFs equal (1e-12); inflation fixings and seasonality survive."""

import importlib
import io
import json

import numpy as np
import pytest
import torch

import torch_cases as tc

PKGS = ("adrates_tpu", "adrates_torch")


def _model(pkg: str):
    """The quick start's four curves, plus a seasonal, fixed RPI curve on
    the COMPOUND scheme and an XCCY curve on a PCHIP foreign parent."""
    u = importlib.import_module(f"{pkg}.utils")
    m, _ = tc.quickstart_model(pkg)
    seas = {k: 1.0 for k in range(1, 13)}
    seas[1], seas[7] = 1.002, 0.998
    m.build_inflation_curve(
        "USD_CPI_INFLATION", breakeven_list=[2.6, 2.45, 2.4],
        tenor_list=["2Y", "5Y", "10Y"], base_cpi=308.0,
        index_type=u.InflationIndexTypes.US_CPI_U,
        seasonality_factors=seas,
        fixings=[(u.Date(1, 10, 2023), 306.0), (u.Date(1, 11, 2023), 307.1)],
        interp_type=u.InflationInterpTypes.COMPOUND)
    m.build_curve("EUR_OIS_ESTR", px_list=[3.9, 3.7, 3.3, 2.9, 2.8],
                  tenor_list=["3M", "1Y", "2Y", "5Y", "10Y"],
                  fixed_dcc_type=u.DayCountTypes.ACT_360,
                  float_dc_type=u.DayCountTypes.ACT_360,
                  interp_type=u.InterpTypes.PCHIP_LOG_DISCOUNT)
    m.build_xccy_curve(name="EUR_USD_BASIS",
                       domestic_curve_name="USD_OIS_SOFR",
                       foreign_curve_name="EUR_OIS_ESTR",
                       basis_spreads=[-10.0, -12.0, -14.0],
                       tenor_list=["1Y", "5Y", "10Y"], spot_fx=1.09)
    m.build_fx(["EURUSD"], [1.09])
    return m


@pytest.fixture(scope="module")
def models():
    return {pkg: _model(pkg) for pkg in PKGS}


def _dfs(curve) -> np.ndarray:
    d = curve._dfs
    return d.numpy() if isinstance(d, torch.Tensor) else np.asarray(d)


def test_same_params_and_same_text(models):
    got, ref = models["adrates_torch"], models["adrates_tpu"]
    assert list(got._curve_params_dict) == list(ref._curve_params_dict)
    for name, params in ref._curve_params_dict.items():
        assert list(got._curve_params_dict[name]) == list(params), name
    assert got.to_json() == ref.to_json()


def test_port_round_trip_is_bit_identical(models, tmp_path):
    m = models["adrates_torch"]
    Model = type(m)
    path = str(tmp_path / "model.json")
    m.to_json(path)
    buf = io.StringIO()
    m.to_json(buf)
    for source in (path, m.to_json(), io.StringIO(buf.getvalue())):
        m2 = Model.from_json(source)
        assert m2.value_dt == m.value_dt
        # rebuilt in dependency order: OIS, then XCCY, then inflation
        assert sorted(m2.curves.keys()) == sorted(m.curves.keys())
        for name in m.curves.keys():
            np.testing.assert_array_equal(_dfs(m2.curves[name]),
                                          _dfs(m.curves[name]), err_msg=name)
        assert m2.fx("GBPUSD") == 1.27 and m2.fx("EURUSD") == 1.09
    c2 = m2.curves["USD_CPI_INFLATION"]
    idx = c2._used_swaps[0]._inflation_index
    assert idx._seasonality_factors.get(1) == pytest.approx(1.002)
    assert idx._get_historical_index(type(m.value_dt)(1, 10, 2023)) == \
        pytest.approx(306.0)


@pytest.mark.parametrize("writer,reader", [("adrates_tpu", "adrates_torch"),
                                           ("adrates_torch", "adrates_tpu")])
def test_json_loads_in_the_other_package(models, writer, reader):
    text = models[writer].to_json()
    Model = importlib.import_module(f"{reader}.models").Model
    m2 = Model.from_json(text)
    ref = models[reader]
    assert sorted(m2.curves.keys()) == sorted(ref.curves.keys())
    for name in ref.curves.keys():
        got, want = _dfs(m2.curves[name]), _dfs(ref.curves[name])
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12,
                                   err_msg=name)
    assert json.loads(m2.to_json()) == json.loads(text)
