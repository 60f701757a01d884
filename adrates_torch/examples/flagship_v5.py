"""The flagship_v5 book-risk configuration, built with the port alone.

The book the repository's ``bench.py`` measures (``build_model``,
``bench.py:47-116``; ``build_base_trades``, ``:119-350``; tiling and
shocks, ``:449``, ``:510-512``, ``:525``): 12 curves — the seven OIS
curves of ``flagship_ois.py``, the three XCCY basis curves of
``flagship_ois_xccy.py`` over USD_OIS_SOFR and two 8-pillar inflation
curves (GBP_RPI_INFLATION, base CPI 293; USD_CPI_INFLATION, base 308,
US_CPI_U) — so N = 144 + 24 + 16 = 184 quotes; 1,004 topology-distinct
base trades: 720 OIS, 60 FRNs (24 capped and floored), 60 float/float
XCCY basis swaps, 60 bonds (15 amortizing), 26 ZCIS and 26 YoY inflation
swaps, 20 fix-float and 12 fix-fix XCCY swaps and 20 GBP/EUR OIS under
USD collateral; compiled in USD with ``stage_buckets="coarse"`` (stages
ois x7, xccy x3, infl x2) and tiled x100 to 100,400 trades with per-copy
notional scales, under 100 scenarios of N(0, 1e-3) quote shocks.

Seed 7 and ``bench.py``'s draw order (trades, then the tile scales, then
the shocks), so the book, the scales and the shocks are ``bench.py``'s
own.

``build_model(schemes=...)`` moves OIS curves onto other interpolation
schemes (default: every curve FLAT_FWD_RATES, as ``bench.py``);
``SPLINE_SCHEMES`` puts five of the seven on the fitted schemes — GBP
PCHIP_LOG_DISCOUNT, USD (the XCCY curves' domestic parent, recalibrated)
PCHIP_ZERO_RATES, EUR NATCUBIC_LOG_DISCOUNT, JPY NATCUBIC_ZERO_RATES, AUD
FINCUBIC_ZERO_RATES — and leaves CHF and CAD on FLAT_FWD_RATES, so the
one OIS stage mixes simple and fitted members and the three XCCY curves
sit over three different fitted foreign schemes. The book, the seed, the
draw order and the tiling are unchanged.
"""

from __future__ import annotations

import numpy as np

from ..models import Model
from ..parallel.multibook import MultiBook, compile_multibook, tile_multibook
from ..trades.credit import FRN, Bond
from ..trades.rates import (OIS, XccyBasisSwap, XccyFixFix, XccyFixFloat,
                            YoYInflationSwap, ZeroCouponInflationSwap)
from ..utils import (BusDayAdjustTypes, CollateralType, CurrencyTypes,
                     CurveTypes, DayCountTypes, FrequencyTypes,
                     InflationIndexTypes, InterpTypes, SwapTypes)
from . import flagship_ois
from .flagship_ois_xccy import XCCY_CURVES, XCCY_TENORS

INFL_TENORS = ["1Y", "2Y", "3Y", "5Y", "7Y", "10Y", "20Y", "30Y"]
INFL_CURVES = [  # (name, base CPI, breakevens in percent, index type)
    ("GBP_RPI_INFLATION", 293.0,
     [3.9, 3.75, 3.6, 3.5, 3.45, 3.5, 3.45, 3.35],
     InflationIndexTypes.UK_RPI),
    ("USD_CPI_INFLATION", 308.0,
     [2.6, 2.45, 2.4, 2.35, 2.35, 2.4, 2.45, 2.4],
     InflationIndexTypes.US_CPI_U),
]

VALUE_DT = flagship_ois.VALUE_DT
N_TRADES = 100_000                 # tiled to the first multiple above
N_SCENARIOS = 100
SEED = 7

SPLINE_SCHEMES = {
    "GBP_OIS_SONIA": InterpTypes.PCHIP_LOG_DISCOUNT,
    "USD_OIS_SOFR": InterpTypes.PCHIP_ZERO_RATES,
    "EUR_OIS_ESTR": InterpTypes.NATCUBIC_LOG_DISCOUNT,
    "JPY_OIS_TONAR": InterpTypes.NATCUBIC_ZERO_RATES,
    "AUD_OIS_AONIA": InterpTypes.FINCUBIC_ZERO_RATES,
}


def build_model(schemes=None) -> Model:
    """The 12 curves (each through its refit gate) and the FX, in
    ``bench.py``'s two waves (XCCY needs its parent OIS curves).
    ``schemes`` maps an OIS curve's name to its interpolation scheme (the
    others FLAT_FWD_RATES)."""
    schemes = schemes or {}
    m = Model(VALUE_DT)

    def shifted(rates, d):
        return [r + d for r in rates]

    main, tenors = flagship_ois.MAIN_RATES, flagship_ois.MAIN_TENORS
    small_tenors = flagship_ois.SMALL_TENORS
    small = [main[tenors.index(t)] for t in small_tenors]

    def ois(name, px, ten, dc):
        return lambda: m.build_curve(
            name, px_list=px, tenor_list=ten, fixed_dcc_type=dc,
            float_dc_type=dc,
            interp_type=schemes.get(name, InterpTypes.FLAT_FWD_RATES))

    wave1 = [ois("GBP_OIS_SONIA", main, tenors, DayCountTypes.ACT_365F),
             ois("USD_OIS_SOFR", shifted(main, 0.35), tenors,
                 DayCountTypes.ACT_360),
             ois("EUR_OIS_ESTR", shifted(main, -1.2), tenors,
                 DayCountTypes.ACT_360)]
    wave1 += [ois(name, shifted(small, d), small_tenors, dc)
              for name, d, dc in
              [("JPY_OIS_TONAR", -3.2, DayCountTypes.ACT_365F),
               ("CHF_OIS_SARON", -2.5, DayCountTypes.ACT_360),
               ("AUD_OIS_AONIA", 0.1, DayCountTypes.ACT_365F),
               ("CAD_OIS_CORRA", 0.6, DayCountTypes.ACT_365F)]]
    m.build_fx(["GBPUSD", "EURUSD", "JPYUSD", "CHFUSD", "AUDUSD",
                "CADUSD"],
               [1.27, 1.09, 0.0069, 1.13, 0.66, 0.74])

    def xccy(name, dom, forn, fx, spr):
        return lambda: m.build_xccy_curve(
            name=name, domestic_curve_name=dom, foreign_curve_name=forn,
            basis_spreads=[spr + 0.5 * i for i in range(len(XCCY_TENORS))],
            tenor_list=XCCY_TENORS, spot_fx=fx)

    def infl(name, base_cpi, bes, index_type):
        return lambda: m.build_inflation_curve(
            name, base_cpi=base_cpi, breakeven_list=bes,
            tenor_list=INFL_TENORS, index_type=index_type)

    wave2 = [xccy(*c) for c in XCCY_CURVES] + [infl(*c) for c in INFL_CURVES]
    m.build_parallel(wave1, wave2)
    return m


def build_base_trades(model: Model, rng: np.random.Generator):
    """(trades, collateral_types): the 1,004 base trades in ``bench.py``'s
    order and draw order; collateral entries are None for natural
    collateral."""
    value_dt = model.value_dt
    trades = flagship_ois.build_ois_trades(model, rng)        # 720 OIS
    freqs = [FrequencyTypes.ANNUAL, FrequencyTypes.SEMI_ANNUAL,
             FrequencyTypes.QUARTERLY]

    frn_defs = [(CurveTypes.GBP_OIS_SONIA, CurrencyTypes.GBP,
                 DayCountTypes.ACT_365F),
                (CurveTypes.USD_OIS_SOFR, CurrencyTypes.USD,
                 DayCountTypes.ACT_360)]
    frn_starts = [value_dt, value_dt.add_months(1).add_days(11),
                  value_dt.add_months(4).add_days(3)]
    for idx, ccy, dc in frn_defs:
        for j, ten in enumerate(["2Y", "3Y", "5Y", "7Y", "10Y", "15Y"]):
            for v in range(5):  # 60 FRNs, 24 capped
                capped = v % 2 == 1
                kwargs = dict(cap_rate=0.055, floor_rate=0.015) \
                    if capped else {}
                trades.append(FRN(
                    frn_starts[v % 3], ten,
                    quoted_margin=float(rng.uniform(0.0005, 0.004)),
                    freq_type=freqs[(j + v) % len(freqs)], dc_type=dc,
                    floating_index=idx, currency=ccy,
                    face_value=float(rng.uniform(1e6, 1e7)), **kwargs))

    xccy_starts = [value_dt, value_dt.add_months(3).add_days(5),
                   value_dt.add_months(9).add_days(13),
                   value_dt.add_months(18)]
    pairs = [(CurveTypes.USD_OIS_SOFR, CurveTypes.GBP_OIS_SONIA,
              CurrencyTypes.USD, CurrencyTypes.GBP, 1.27),
             (CurveTypes.USD_OIS_SOFR, CurveTypes.EUR_OIS_ESTR,
              CurrencyTypes.USD, CurrencyTypes.EUR, 1.09),
             (CurveTypes.USD_OIS_SOFR, CurveTypes.JPY_OIS_TONAR,
              CurrencyTypes.USD, CurrencyTypes.JPY, 0.0069)]
    for dom, forn, dom_ccy, for_ccy, fx in pairs:
        for ten in ["2Y", "5Y", "10Y", "20Y", "30Y"]:
            for s in range(4):  # 60 XCCY basis
                dn = float(rng.uniform(5e6, 5e7))
                trades.append(XccyBasisSwap(
                    effective_dt=xccy_starts[s], term_dt_or_tenor=ten,
                    domestic_notional=dn, foreign_notional=dn / fx,
                    domestic_spread=0.0,
                    foreign_spread=float(rng.uniform(-0.002, 0.0)),
                    domestic_freq_type=freqs[2 - s % 2],
                    foreign_freq_type=FrequencyTypes.QUARTERLY,
                    domestic_dc_type=DayCountTypes.ACT_360,
                    foreign_dc_type=DayCountTypes.ACT_365F,
                    domestic_floating_index=dom,
                    foreign_floating_index=forn,
                    domestic_currency=dom_ccy,
                    foreign_currency=for_ccy))

    bond_starts = [value_dt, value_dt.add_months(-31).add_days(9),
                   value_dt.add_months(-9).add_days(21),
                   value_dt.add_months(2)]
    for ccy, dc in [(CurrencyTypes.GBP, DayCountTypes.ACT_365F),
                    (CurrencyTypes.USD, DayCountTypes.THIRTY_360_BOND),
                    (CurrencyTypes.EUR, DayCountTypes.ACT_360)]:
        for j, ten in enumerate(["2Y", "5Y", "7Y", "10Y", "30Y"]):
            for v in range(4):  # 60 bonds, 15 amortizing
                fv = float(rng.uniform(1e6, 1e7))
                freq = (FrequencyTypes.SEMI_ANNUAL if (j + v) % 2
                        else FrequencyTypes.ANNUAL)
                kwargs = {}
                if v == 3:
                    # equal-principal amortizer over coupon periods
                    n_per = int(ten[:-1]) * (
                        2 if freq == FrequencyTypes.SEMI_ANNUAL else 1)
                    kwargs["amortization_schedule"] = [fv / n_per] * n_per
                trades.append(Bond(
                    bond_starts[v], ten,
                    coupon=float(rng.uniform(0.01, 0.06)),
                    freq_type=freq, dc_type=dc, currency=ccy,
                    face_value=fv, **kwargs))

    infl_tenors = ["13M", "2Y", "3Y", "4Y", "5Y", "6Y", "7Y", "8Y",
                   "10Y", "12Y", "15Y", "20Y", "30Y"]
    for infl_name, *_ in INFL_CURVES:
        index = model.curves[infl_name]._used_swaps[0]._inflation_index
        for j, ten in enumerate(infl_tenors):  # 52 inflation
            trades.append(ZeroCouponInflationSwap(
                effective_dt=value_dt, term_dt_or_tenor=ten,
                fixed_leg_type=SwapTypes.PAY if j % 2 else
                SwapTypes.RECEIVE,
                fixed_rate=float(rng.uniform(0.02, 0.04)),
                inflation_index=index,
                notional=float(rng.uniform(1e6, 1e7))))
            trades.append(YoYInflationSwap(
                effective_dt=value_dt, term_dt_or_tenor=ten,
                fixed_leg_type=SwapTypes.RECEIVE if j % 2 else
                SwapTypes.PAY,
                fixed_rate=float(rng.uniform(0.02, 0.04)),
                inflation_index=index, freq_type=FrequencyTypes.ANNUAL,
                notional=float(rng.uniform(1e6, 1e7)),
                inflation_spread=float(rng.uniform(-0.001, 0.001))))

    collateral_types = [None] * len(trades)

    for dom, forn, dom_ccy, for_ccy, fx in pairs[:2]:
        for j, ten in enumerate(["2Y", "5Y", "10Y", "20Y", "30Y"]):
            for s in range(2):  # 20 fix-float
                dn = float(rng.uniform(5e6, 3e7))
                trades.append(XccyFixFloat(
                    effective_dt=xccy_starts[s], term_dt_or_tenor=ten,
                    domestic_notional=dn, foreign_notional=dn / fx,
                    domestic_leg_type=SwapTypes.PAY if j % 2 else
                    SwapTypes.RECEIVE,
                    domestic_coupon=float(rng.uniform(0.02, 0.05)),
                    foreign_spread=float(rng.uniform(-0.002, 0.0)),
                    domestic_freq_type=FrequencyTypes.SEMI_ANNUAL,
                    foreign_freq_type=FrequencyTypes.QUARTERLY,
                    domestic_dc_type=DayCountTypes.ACT_360,
                    foreign_dc_type=DayCountTypes.ACT_365F,
                    domestic_floating_index=dom,
                    foreign_floating_index=forn,
                    domestic_currency=dom_ccy,
                    foreign_currency=for_ccy))
                collateral_types.append(None)
        for ten in ["5Y", "10Y", "30Y"]:
            for s in range(2):  # 12 fix-fix
                dn = float(rng.uniform(5e6, 3e7))
                trades.append(XccyFixFix(
                    effective_dt=xccy_starts[s + 1], term_dt_or_tenor=ten,
                    domestic_notional=dn, foreign_notional=dn / fx,
                    domestic_leg_type=SwapTypes.RECEIVE,
                    domestic_coupon=float(rng.uniform(0.02, 0.05)),
                    foreign_coupon=float(rng.uniform(0.02, 0.05)),
                    domestic_freq_type=FrequencyTypes.ANNUAL,
                    foreign_freq_type=FrequencyTypes.ANNUAL,
                    domestic_dc_type=DayCountTypes.ACT_360,
                    foreign_dc_type=DayCountTypes.ACT_365F,
                    domestic_floating_index=dom,
                    foreign_floating_index=forn,
                    domestic_currency=dom_ccy,
                    foreign_currency=for_ccy))
                collateral_types.append(None)

    starts = flagship_ois.start_dates(value_dt)
    for idx, ccy, dc in [
            (CurveTypes.GBP_OIS_SONIA, CurrencyTypes.GBP,
             DayCountTypes.ACT_365F),
            (CurveTypes.EUR_OIS_ESTR, CurrencyTypes.EUR,
             DayCountTypes.ACT_360)]:
        for j, ten in enumerate(["2Y", "3Y", "5Y", "7Y", "10Y", "12Y",
                                 "15Y", "20Y", "25Y", "30Y"]):
            trades.append(OIS(  # 20 collateralized
                starts[(j * 5) % len(starts)], ten,
                SwapTypes.PAY if j % 2 else SwapTypes.RECEIVE,
                float(rng.uniform(0.01, 0.06)),
                FrequencyTypes.ANNUAL, dc, idx, ccy,
                notional=float(rng.uniform(1e6, 2e7)), float_dc_type=dc,
                bd_type=BusDayAdjustTypes.MODIFIED_FOLLOWING))
            collateral_types.append(CollateralType.USD)
    return trades, collateral_types


def compile_base(model: Model, trades, collateral_types, **kw) -> MultiBook:
    """The base book as ``bench.py`` compiles it (``kw`` goes to
    compile_multibook, e.g. ``batch_curves``)."""
    return compile_multibook(trades, model, base_currency=CurrencyTypes.USD,
                             n_buckets=4, collateral_types=collateral_types,
                             stage_buckets="coarse", **kw)


def build_book(model: Model, rng: np.random.Generator, **kw):
    """(tiled book [100,400 trades], shocks [100, N]): the base trades,
    then the tile scales, then the shocks, in ``bench.py``'s draw
    order."""
    trades, coll = build_base_trades(model, rng)
    mb = compile_base(model, trades, coll, **kw)
    n_copies = -(-N_TRADES // len(trades))
    tiled = tile_multibook(mb, n_copies,
                           notional_scale=rng.uniform(0.5, 2.0, n_copies))
    shocks = rng.normal(0.0, 1e-3, (N_SCENARIOS, mb.basket.n_quotes))
    return tiled, shocks
