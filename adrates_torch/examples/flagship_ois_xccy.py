"""The flagship OIS + XCCY book-risk configuration, built with the port
alone.

The seven OIS curves of ``flagship_ois.py`` (N = 144 quotes) plus the
three XCCY basis curves of the repository's ``bench.py`` flagship
configuration (``bench.py:83-88``, ``:103-108``): GBP_USD_XCCY,
EUR_USD_XCCY and JPY_USD_XCCY over USD_OIS_SOFR, 8 basis pillars each
(``XCCY_TENORS``, ``bench.py:44``), so N = 144 + 24 = 168 quotes, with
in-graph recalibration (a USD or foreign rate shock moves the XCCY
curves). Trades: the 720 OIS of ``flagship_ois.py``, the 60
float/float basis swaps of ``bench.py:206-231`` and the 20 GBP/EUR OIS
under USD collateral of ``bench.py:331-348`` (discounted on their
{CCY}_USD_XCCY curves): 800 base trades tiled x125 to 100,000 with
per-copy notional scales, priced in USD under 100 scenarios of
N(0, 1e-3) quote shocks, seed 7, ``stage_buckets="coarse"`` (one 7-curve
OIS stage, one 3-curve XCCY stage).

Cut from flagship_v5: its FRNs, bonds, inflation curves and trades, and
fix-float and fix-fix XCCY swaps (not ported). Trade parameters come
from this file's own seeded generator in the order above, not from
``bench.py``'s draw order, where the FRN and bond draws sit between the
OIS and the XCCY swaps; so the same seed gives other notionals and
spreads than ``bench.py`` for the XCCY and collateralized trades.
"""

from __future__ import annotations

import numpy as np

from ..models import Model
from ..trades.rates import OIS, XccyBasisSwap
from ..utils import (BusDayAdjustTypes, CollateralType, CurrencyTypes,
                     CurveTypes, DayCountTypes, FrequencyTypes, SwapTypes)
from . import flagship_ois

XCCY_TENORS = ["1Y", "2Y", "3Y", "5Y", "7Y", "10Y", "20Y", "30Y"]
XCCY_CURVES = [  # (name, domestic, foreign, spot fx, first spread in bp)
    ("GBP_USD_XCCY", "USD_OIS_SOFR", "GBP_OIS_SONIA", 1.27, -8.0),
    ("EUR_USD_XCCY", "USD_OIS_SOFR", "EUR_OIS_ESTR", 1.09, -18.0),
    ("JPY_USD_XCCY", "USD_OIS_SOFR", "JPY_OIS_TONAR", 0.0069, -40.0),
]

VALUE_DT = flagship_ois.VALUE_DT
N_BASE = 800
N_TRADES = 100_000
N_SCENARIOS = 100
SEED = 7


def build_model() -> Model:
    """The seven OIS curves and FX of ``flagship_ois.py`` plus the three
    XCCY curves (each passes its 1e-10 refit gate)."""
    m = flagship_ois.build_model()
    for name, dom, forn, fx, spr in XCCY_CURVES:
        m.build_xccy_curve(
            name=name, domestic_curve_name=dom, foreign_curve_name=forn,
            basis_spreads=[spr + 0.5 * i for i in range(len(XCCY_TENORS))],
            tenor_list=XCCY_TENORS, spot_fx=fx)
    return m


def build_trades(model: Model, rng: np.random.Generator):
    """(trades, collateral_types): the 720 OIS, the 60 basis swaps and
    the 20 OIS under USD collateral; collateral entries are None for
    natural collateral."""
    value_dt = model.value_dt
    trades = flagship_ois.build_ois_trades(model, rng)
    freqs = [FrequencyTypes.ANNUAL, FrequencyTypes.SEMI_ANNUAL,
             FrequencyTypes.QUARTERLY]

    xccy_starts = [value_dt, value_dt.add_months(3).add_days(5),
                   value_dt.add_months(9).add_days(13),
                   value_dt.add_months(18)]
    for dom, forn, dom_ccy, for_ccy, fx in [
            (CurveTypes.USD_OIS_SOFR, CurveTypes.GBP_OIS_SONIA,
             CurrencyTypes.USD, CurrencyTypes.GBP, 1.27),
            (CurveTypes.USD_OIS_SOFR, CurveTypes.EUR_OIS_ESTR,
             CurrencyTypes.USD, CurrencyTypes.EUR, 1.09),
            (CurveTypes.USD_OIS_SOFR, CurveTypes.JPY_OIS_TONAR,
             CurrencyTypes.USD, CurrencyTypes.JPY, 0.0069)]:
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
    collateral_types = [None] * len(trades)

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
