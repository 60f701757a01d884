"""The port's FX routing (``adrates_torch/marketdata``, ``Model.fx``)
against the JAX package's, on the routing cases of
``tests/test_marketdata.py``: rates equal to 1e-15 rel, identical paths,
the same errors; ``Model.fx`` on routed pairs of flagship_v5's USD-quoted
FX set; and the override recursion both packages share (ROADMAP §C)."""

import importlib

import pytest

PKGS = ("adrates_tpu", "adrates_torch")
CASES = [  # (fx params, base, quote)
    ({"GBPUSD": 1.27}, "GBP", "USD"),
    ({"GBPUSD": 1.27}, "USD", "GBP"),
    ({"GBPUSD": 1.27, "EURUSD": 1.08}, "EUR", "GBP"),
    ({"EURUSD": 1.08, "USDJPY": 150.0, "GBPUSD": 1.27}, "GBP", "JPY"),
    ({"EURUSD": 1.08, "USDJPY": 150.0, "GBPUSD": 1.27}, "JPY", "EUR"),
    ({"GBPUSD": 1.27}, "USD", "USD"),
    ({"GBPUSD": 1.27, "EURUSD": 1.09, "JPYUSD": 0.0069, "CHFUSD": 1.13,
      "AUDUSD": 0.66, "CADUSD": 0.74, "EURGBP": 0.86}, "CHF", "CAD"),
    ({"GBPUSD": 1.27, "EURUSD": 1.09, "JPYUSD": 0.0069, "CHFUSD": 1.13,
      "AUDUSD": 0.66, "CADUSD": 0.74, "EURGBP": 0.86}, "EUR", "JPY"),
]


def _engine(pkg, params=None):
    mod = importlib.import_module(f"{pkg}.marketdata.market_data_engine")
    return mod.FXRoutingEngine(params)


def _lib_error(pkg):
    return importlib.import_module(f"{pkg}.utils").LibError


def _rel(a, b):
    return abs(a - b) / abs(b)


@pytest.mark.parametrize("params,base,quote", CASES)
def test_routing_matches_jax(params, base, quote):
    got, ref = _engine("adrates_torch", params), _engine("adrates_tpu",
                                                         params)
    assert _rel(got.get_cross_rate(base, quote),
                ref.get_cross_rate(base, quote)) <= 1e-15
    assert _rel(got.rate(base + quote), ref.rate(base + quote)) <= 1e-15
    assert got.get_path(base, quote) == ref.get_path(base, quote)
    g_rate, g_path = got.get_cross_rate_with_path(base, quote)
    r_rate, r_path = ref.get_cross_rate_with_path(base, quote)
    assert g_path == r_path and _rel(g_rate, r_rate) <= 1e-15


def test_reference_values():
    """tests/test_marketdata.py's expected rates, on the port."""
    r = _engine("adrates_torch", {"GBPUSD": 1.27})
    assert r.rate("GBPUSD") == 1.27
    assert r.rate("USDGBP") == pytest.approx(1 / 1.27)
    r = _engine("adrates_torch", {"GBPUSD": 1.27, "EURUSD": 1.08})
    assert r.get_cross_rate("EUR", "GBP") == pytest.approx(1.08 / 1.27)
    assert r.get_path("EUR", "GBP") == ["EUR", "USD", "GBP"]
    r = _engine("adrates_torch", None)
    r.set_bulk_fx_rates({"EURUSD": 1.08, "GBPUSD": 1.27})
    assert r.rate("EURUSD") == 1.08


@pytest.mark.parametrize("pkg", PKGS)
def test_errors(pkg):
    LibError = _lib_error(pkg)
    r = _engine(pkg, {"GBPUSD": 1.27})
    with pytest.raises(LibError, match="No FX route"):
        r.get_cross_rate("EUR", "JPY")
    assert r.get_cross_rate_with_path("EUR", "JPY") == (None, [])
    assert r.get_path("EUR", "JPY") == []
    with pytest.raises(LibError, match="positive"):
        r.set_fx_rate("GBPUSD", -1.0)


@pytest.mark.parametrize("params,ccy,via,base,quote", [
    ({"GBPUSD": 1.27, "EURUSD": 1.08, "EURGBP": 0.85}, "EUR", "USD", "EUR",
     "GBP"),
    ({"GBPUSD": 1.27, "EURUSD": 1.08, "USDJPY": 150.0}, "GBP", "EUR", "GBP",
     "JPY"),
])
def test_overrides_match_jax(params, ccy, via, base, quote):
    rates = []
    for pkg in PKGS:
        r = _engine(pkg, params)
        r.set_override(ccy, via)
        rates.append(r.get_cross_rate(base, quote))
    assert _rel(rates[1], rates[0]) <= 1e-15


@pytest.mark.parametrize("pkg", PKGS)
def test_self_override_recurses_in_both(pkg):
    """In the reference, reproduced (ROADMAP §C): ``set_override(c, c)``
    makes ``get_cross_rate`` call itself with the same arguments until
    the interpreter's recursion limit."""
    r = _engine(pkg, {"GBPUSD": 1.27, "EURUSD": 1.08})
    r.set_override("GBP", "GBP")
    with pytest.raises(RecursionError):
        r.get_cross_rate("GBP", "EUR")


@pytest.mark.parametrize("pair", ["GBPJPY", "EURCHF", "JPYGBP", "CADAUD"])
def test_model_fx_routes(pair):
    """Model.fx on flagship_v5's XXXUSD set: a pair with neither itself
    nor its inverse quoted is routed through USD, as in JAX."""
    pairs = ["GBPUSD", "EURUSD", "JPYUSD", "CHFUSD", "AUDUSD", "CADUSD"]
    pxs = [1.27, 1.09, 0.0069, 1.13, 0.66, 0.74]
    out = {}
    for pkg in PKGS:
        m = importlib.import_module(f"{pkg}.models").Model(
            importlib.import_module(f"{pkg}.utils").Date(1, 1, 2024))
        m.build_fx(pairs, pxs)
        out[pkg] = m.fx(pair)
        assert m.fx("GBPUSD") == 1.27
        assert m.fx("USDGBP") == 1.0 / 1.27
    legs = dict(zip(pairs, pxs))
    cross = legs[pair[:3] + "USD"] / legs[pair[3:] + "USD"]
    assert _rel(out["adrates_torch"], cross) <= 1e-15
    assert _rel(out["adrates_torch"], out["adrates_tpu"]) <= 1e-15


def test_model_fx_without_route_raises():
    for pkg in PKGS:
        Model = importlib.import_module(f"{pkg}.models").Model
        m = Model(importlib.import_module(f"{pkg}.utils").Date(1, 1, 2024))
        m.build_fx(["GBPUSD"], [1.27])
        with pytest.raises(_lib_error(pkg), match="No FX route"):
            m.fx("EURJPY")
