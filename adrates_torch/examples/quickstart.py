"""End-to-end tour of the port: ``examples/quickstart.py`` with
``adrates_tpu`` replaced by ``adrates_torch``.

Covers: multi-curve build, OIS pricing with full AD risk, scenario P&L
attribution, XCCY multi-curve risk, inflation swaps, bonds/FRNs, and
book-scale batched pricing (the single-curve book on the K1 kernel). The
curves, trades, seed and sizes are the JAX script's.

    python3 -m adrates_torch.examples.quickstart        # on the CUDA card

``main(device=None)`` runs it on ``device`` (None: the card; pass
``device="cpu"`` to run it on the host) and returns its printed numbers.
The engine's tenor ladder is printed as (tenor, value) pairs: the
DataFrame view needs pandas, which the port does not require.
"""

from __future__ import annotations

import numpy as np

from ..models import Model
from ..parallel import aggregate_book, compile_book, make_book_fn, tile_book
from ..trades.credit import FRN, Bond
from ..trades.rates import (OIS, XccyBasisSwap, YoYInflationSwap,
                            ZeroCouponInflationSwap)
from ..utils import (BusDayAdjustTypes, CurrencyTypes, CurveTypes, Date,
                     DayCountTypes, FrequencyTypes, InterpTypes,
                     RequestTypes, SwapTypes)

VALUE_DT = Date(1, 1, 2024)
GBP_TENORS = ["1M", "6M", "1Y", "18M", "2Y", "3Y", "5Y", "7Y", "10Y", "12Y",
              "20Y", "30Y", "50Y"]
GBP_RATES = [5.19, 5.04, 4.71, 4.51, 4.35, 4.13, 3.93, 3.87, 3.87, 3.89,
             3.88, 3.71, 3.33]
BOOK_TENORS = ["2Y", "5Y", "10Y", "30Y"] * 5     # the 20 base OIS
BOOK_COPIES = 50                                 # 1,000 trades
BOOK_SCENARIOS = 10


def build_model():
    """(model, RPI index): GBP SONIA (13 pillars), USD SOFR, the GBP/USD
    basis curve, GBPUSD and the GBP RPI curve with its index."""
    model = Model(VALUE_DT)
    model.build_curve(
        "GBP_OIS_SONIA", px_list=GBP_RATES, tenor_list=GBP_TENORS,
        fixed_dcc_type=DayCountTypes.ACT_365F,
        float_dc_type=DayCountTypes.ACT_365F)
    model.build_curve(
        "USD_OIS_SOFR",
        px_list=[5.33, 5.05, 4.60, 4.25, 4.00, 3.90, 3.88, 3.92, 3.85],
        tenor_list=["6M", "1Y", "2Y", "3Y", "5Y", "7Y", "10Y", "20Y",
                    "30Y"],
        fixed_dcc_type=DayCountTypes.ACT_360,
        float_dc_type=DayCountTypes.ACT_360,
        interp_type=InterpTypes.FLAT_FWD_RATES)
    model.build_xccy_curve(
        name="GBP_USD_BASIS", domestic_curve_name="USD_OIS_SOFR",
        foreign_curve_name="GBP_OIS_SONIA",
        basis_spreads=[-2.0, -5.0, -8.0, -11.0, -13.0],
        tenor_list=["1Y", "2Y", "5Y", "10Y", "30Y"], spot_fx=1.27)
    model.build_fx(["GBPUSD"], [1.27])
    _, rpi = model.build_inflation_curve(
        "GBP_RPI_INFLATION",
        breakeven_list=[3.8, 3.6, 3.5, 3.4, 3.5, 3.45, 3.3],
        tenor_list=["1Y", "2Y", "3Y", "5Y", "10Y", "20Y", "30Y"],
        base_cpi=293.0)
    return model, rpi


def ten_year_swap() -> OIS:
    """The tour's 10Y RECEIVE 3.87% GBP OIS, 10M notional."""
    return OIS(VALUE_DT, "10Y", SwapTypes.RECEIVE, 0.0387,
               FrequencyTypes.ANNUAL, DayCountTypes.ACT_365F,
               CurveTypes.GBP_OIS_SONIA, CurrencyTypes.GBP,
               notional=10_000_000, float_dc_type=DayCountTypes.ACT_365F,
               bd_type=BusDayAdjustTypes.MODIFIED_FOLLOWING)


def book_swaps(rng: np.random.Generator) -> list:
    """The 20 base OIS of the book section (coupons from ``rng``)."""
    return [OIS(VALUE_DT, ten,
                SwapTypes.PAY if i % 2 else SwapTypes.RECEIVE,
                float(rng.uniform(0.02, 0.05)), FrequencyTypes.ANNUAL,
                DayCountTypes.ACT_365F, CurveTypes.GBP_OIS_SONIA,
                CurrencyTypes.GBP, notional=1e6,
                float_dc_type=DayCountTypes.ACT_365F,
                bd_type=BusDayAdjustTypes.MODIFIED_FOLLOWING)
            for i, ten in enumerate(BOOK_TENORS)]


def main(device=None) -> dict:
    """Run the tour on ``device`` and return its printed numbers."""
    R = RequestTypes
    out = {}
    model, rpi = build_model()
    print("curves:", list(model.curves.keys()))

    # ------------------------------------------------------------ OIS + risk
    swap = ten_year_swap()
    res = swap.position(model, device=device).compute(
        [R.VALUE, R.DELTA, R.GAMMA, R.CASHFLOWS])
    out["pv_10y"] = res.value.amount
    print("\n10Y OIS PV:", res.value)
    for tenor, v in list(res.risk.ladder.data.items())[:8]:
        print(f"  {tenor:>4} {v:14.6f}")
    print("gamma total (per bp^2):", res.gamma.value)
    print("cashflow rows:", len(res.cashflows))
    out["gamma_total"] = res.gamma.value.amount
    out["cashflow_rows"] = len(res.cashflows)

    # Scenario P&L attribution: +100bp parallel
    shocked = model.scenario("GBP_OIS_SONIA", 1.0)
    pnl = swap.value(VALUE_DT, shocked.curves.GBP_OIS_SONIA) \
        - swap.value(VALUE_DT, model.curves.GBP_OIS_SONIA)
    order1 = float(np.sum(res.risk.risk_ladder)) * 100
    order2 = order1 + 0.5 * float(np.sum(res.gamma.risk_ladder)) * 100 ** 2
    print(f"\n+100bp P&L: actual {pnl:,.0f}  1st-order {order1:,.0f}  "
          f"1st+2nd {order2:,.0f}")
    out.update(pnl_100bp=pnl, pnl_order1=order1, pnl_order2=order2)

    # ------------------------------------------------------------------ XCCY
    basis = XccyBasisSwap(VALUE_DT, "7Y", 100e6, 100e6 / 1.27, 0.0, -0.0009,
                          FrequencyTypes.ANNUAL, FrequencyTypes.ANNUAL,
                          DayCountTypes.ACT_360, DayCountTypes.ACT_365F,
                          CurveTypes.USD_OIS_SOFR, CurveTypes.GBP_OIS_SONIA,
                          CurrencyTypes.USD, CurrencyTypes.GBP)
    xres = basis.position(model, device=device).compute([R.VALUE, R.DELTA])
    print("\n7Y XCCY basis swap PV:", xres.value)
    print("risk:", xres.risk)
    out["xccy_pv"] = xres.value.amount

    # ------------------------------------------------------------- inflation
    infl_curve = model.curves.GBP_RPI_INFLATION
    zcis = ZeroCouponInflationSwap(VALUE_DT, "5Y", SwapTypes.PAY, 0.034, rpi,
                                   notional=10_000_000)
    zres = zcis.position(model, device=device).compute([R.VALUE, R.DELTA])
    print("\n5Y ZCIS PV:", zres.value, "| risk:", zres.risk)
    yoy = YoYInflationSwap(VALUE_DT, "5Y", SwapTypes.PAY, 0.034, rpi,
                           FrequencyTypes.ANNUAL, notional=10_000_000)
    be = yoy.breakeven_rate(VALUE_DT, model.curves.GBP_OIS_SONIA, infl_curve)
    print(f"5Y YoY breakeven: {be * 100:.3f}%")
    out.update(zcis_pv=zres.value.amount, yoy_breakeven=be)

    # ---------------------------------------------------------------- credit
    bond = Bond(VALUE_DT, "10Y", 0.04, FrequencyTypes.SEMI_ANNUAL,
                DayCountTypes.THIRTY_E_360, CurrencyTypes.GBP)
    gbp = model.curves.GBP_OIS_SONIA
    px = bond.clean_price(VALUE_DT, gbp)
    ytm = bond.yield_to_maturity(VALUE_DT, px)
    dur = bond.duration(VALUE_DT, gbp)
    print(f"\n10Y 4% bond: clean {px:.4f}  ytm {ytm * 100:.3f}%  "
          f"duration {dur:.2f}")
    frn = FRN(VALUE_DT, "5Y", 0.005, FrequencyTypes.QUARTERLY,
              DayCountTypes.ACT_365F, CurrencyTypes.GBP,
              CurveTypes.GBP_OIS_SONIA)
    frn_px = frn.clean_price(VALUE_DT, gbp, gbp)
    print(f"5Y FRN +50bp: clean {frn_px:.4f}")
    out.update(bond_clean=px, bond_ytm=ytm, bond_duration=dur,
               frn_clean=frn_px)

    # ------------------------------------------------------------ book scale
    rng = np.random.default_rng(0)
    book = tile_book(compile_book(book_swaps(rng), VALUE_DT), BOOK_COPIES)
    agg = aggregate_book(book)
    fn = make_book_fn(gbp._plan, gbp._interp_type, device=device)
    shocks = rng.normal(0, 1e-3, (BOOK_SCENARIOS, len(gbp.swap_rates)))
    res_book = fn(np.asarray(gbp.swap_rates), book, agg, shocks)
    print(f"\nbook: {book.num_trades} trades x {BOOK_SCENARIOS} scenarios "
          f"-> pvs {tuple(res_book['pvs'].shape)}, delta "
          f"{tuple(res_book['delta'].shape)}, gamma "
          f"{tuple(res_book['gamma'].shape)}")
    out.update(book_trades=book.num_trades,
               book_pv_sums=res_book["pvs"].sum(dim=1).cpu().numpy(),
               book_delta=res_book["delta"].cpu().numpy(),
               book_gamma=res_book["gamma"].cpu().numpy())
    print("done.")
    return out


if __name__ == "__main__":
    main()
