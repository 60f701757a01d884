"""The port's quick start (``adrates_torch/examples/quickstart.py``)
against the same quantities computed through ``adrates_tpu``, on the CPU:
the 10Y OIS's PV, the +100 bp scenario P&L and its first- and
second-order estimates, the XCCY and ZCIS PVs, and the book section's
per-scenario PV sums, delta and gamma (1e-10 rel)."""

import jax.numpy as jnp
import numpy as np
import pytest

import torch_cases as tc
from adrates_tpu.parallel import (aggregate_book, compile_book,
                                  make_book_fn, tile_book)
from adrates_tpu.trades.rates import XccyBasisSwap, ZeroCouponInflationSwap
from adrates_tpu.utils import (CurrencyTypes, CurveTypes, DayCountTypes,
                               FrequencyTypes, RequestTypes, SwapTypes)
from adrates_torch.examples import quickstart


@pytest.fixture(scope="module")
def port():
    return quickstart.main(device="cpu")


@pytest.fixture(scope="module")
def jax_ref():
    """The quick start's numbers through adrates_tpu."""
    R = RequestTypes
    model, rpi = tc.quickstart_model("adrates_tpu")
    v = model.value_dt
    swap = tc.quickstart_ten_year("adrates_tpu")
    res = swap.position(model).compute([R.VALUE, R.DELTA, R.GAMMA])
    shocked = model.scenario("GBP_OIS_SONIA", 1.0)
    order1 = float(np.sum(res.risk.risk_ladder)) * 100
    out = dict(
        pv_10y=res.value.amount,
        pnl_100bp=swap.value(v, shocked.curves.GBP_OIS_SONIA)
        - swap.value(v, model.curves.GBP_OIS_SONIA),
        pnl_order1=order1,
        pnl_order2=order1 + 0.5 * float(np.sum(res.gamma.risk_ladder))
        * 100 ** 2)
    basis = XccyBasisSwap(v, "7Y", 100e6, 100e6 / 1.27, 0.0, -0.0009,
                          FrequencyTypes.ANNUAL, FrequencyTypes.ANNUAL,
                          DayCountTypes.ACT_360, DayCountTypes.ACT_365F,
                          CurveTypes.USD_OIS_SOFR, CurveTypes.GBP_OIS_SONIA,
                          CurrencyTypes.USD, CurrencyTypes.GBP)
    out["xccy_pv"] = basis.position(model).compute([R.VALUE]).value.amount
    zcis = ZeroCouponInflationSwap(v, "5Y", SwapTypes.PAY, 0.034, rpi,
                                   notional=10_000_000)
    out["zcis_pv"] = zcis.position(model).compute([R.VALUE]).value.amount

    rng = np.random.default_rng(0)
    gbp = model.curves.GBP_OIS_SONIA
    book = tile_book(compile_book(tc.quickstart_book_swaps("adrates_tpu",
                                                           rng), v), 50)
    fn = make_book_fn(gbp._plan, gbp._interp_type)
    shocks = jnp.asarray(rng.normal(0, 1e-3, (10, len(gbp.swap_rates))))
    res = fn(jnp.asarray(gbp.swap_rates), book, aggregate_book(book), shocks)
    out.update(book_trades=book.num_trades,
               book_pv_sums=np.asarray(res["pvs"]).sum(axis=1),
               book_delta=np.asarray(res["delta"]),
               book_gamma=np.asarray(res["gamma"]))
    return out


@pytest.mark.parametrize("key", ["pnl_100bp", "pnl_order1", "pnl_order2",
                                 "xccy_pv", "zcis_pv", "book_pv_sums",
                                 "book_delta", "book_gamma"])
def test_quickstart_matches_jax(port, jax_ref, key):
    got, ref = np.asarray(port[key]), np.asarray(jax_ref[key])
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-10 * np.abs(ref).max())


def test_quickstart_ten_year_pv(port, jax_ref):
    """The 10Y swap is at par: its PV is f64 noise on a 10M notional in
    both packages."""
    assert abs(port["pv_10y"] - jax_ref["pv_10y"]) <= 1e-10 * 10_000_000


def test_quickstart_second_order_closer(port):
    assert port["book_trades"] == 1000
    assert abs(port["pnl_order2"] - port["pnl_100bp"]) \
        < abs(port["pnl_order1"] - port["pnl_100bp"])
