"""The flagship OIS book-risk configuration, built with the port alone.

Seven OIS curves (GBP, USD, EUR on 32 pillars; JPY, CHF, AUD, CAD on 12;
N = 144 quotes, FLAT_FWD_RATES), the FX to USD, and 720
topology-distinct OIS (6 currencies x 10 tenors x 12 variants: start
dates spread over four years, mixed day counts, annual/semi-annual/
quarterly, pay lags 0-2, MF/FOLLOWING, PAY/RECEIVE) tiled x139 to
100,080 trades with per-copy notional scales, priced in USD under 100
scenarios of N(0, 1e-3) quote shocks. This is the OIS sub-book of the
repository's ``bench.py`` flagship configuration (``bench.py:60-185``,
``:500-512``); CHF has curves but no trades, so its quotes carry exactly
zero risk after grid compaction.
"""

from __future__ import annotations

import numpy as np

from ..models import Model
from ..trades.rates import OIS
from ..utils import (BusDayAdjustTypes, CurrencyTypes, CurveTypes, Date,
                     DayCountTypes, FrequencyTypes, InterpTypes, SwapTypes)

MAIN_TENORS = ["1M", "2M", "3M", "4M", "5M", "6M", "7M", "8M", "9M", "10M",
               "11M", "1Y", "18M", "2Y", "3Y", "4Y", "5Y", "6Y", "7Y", "8Y",
               "9Y", "10Y", "12Y", "15Y", "20Y", "25Y", "30Y", "35Y", "40Y",
               "45Y", "50Y", "60Y"]
MAIN_RATES = [5.19, 5.17, 5.15, 5.12, 5.09, 5.04, 4.98, 4.92, 4.87, 4.81,
              4.76, 4.71, 4.51, 4.35, 4.13, 4.00, 3.93, 3.89, 3.87, 3.86,
              3.86, 3.87, 3.89, 3.91, 3.88, 3.80, 3.71, 3.61, 3.51, 3.42,
              3.33, 3.21]
SMALL_TENORS = ["3M", "6M", "1Y", "2Y", "3Y", "5Y", "7Y", "10Y", "15Y",
                "20Y", "30Y", "40Y"]

VALUE_DT = Date(1, 1, 2024)
N_TRADES = 100_000
N_SCENARIOS = 100
SEED = 7


def build_model() -> Model:
    """The seven OIS curves (each passes its 1e-10 refit gate) and FX."""
    m = Model(VALUE_DT)

    def shifted(rates, d):
        return [r + d for r in rates]

    small = [MAIN_RATES[MAIN_TENORS.index(t)] for t in SMALL_TENORS]
    curves = [("GBP_OIS_SONIA", MAIN_RATES, MAIN_TENORS,
               DayCountTypes.ACT_365F),
              ("USD_OIS_SOFR", shifted(MAIN_RATES, 0.35), MAIN_TENORS,
               DayCountTypes.ACT_360),
              ("EUR_OIS_ESTR", shifted(MAIN_RATES, -1.2), MAIN_TENORS,
               DayCountTypes.ACT_360)]
    curves += [(name, shifted(small, d), SMALL_TENORS, dc)
               for name, d, dc in
               [("JPY_OIS_TONAR", -3.2, DayCountTypes.ACT_365F),
                ("CHF_OIS_SARON", -2.5, DayCountTypes.ACT_360),
                ("AUD_OIS_AONIA", 0.1, DayCountTypes.ACT_365F),
                ("CAD_OIS_CORRA", 0.6, DayCountTypes.ACT_365F)]]
    for name, px, tenors, dc in curves:
        m.build_curve(name, px_list=px, tenor_list=tenors,
                      fixed_dcc_type=dc, float_dc_type=dc,
                      interp_type=InterpTypes.FLAT_FWD_RATES)
    m.build_fx(["GBPUSD", "EURUSD", "JPYUSD", "CHFUSD", "AUDUSD",
                "CADUSD"],
               [1.27, 1.09, 0.0069, 1.13, 0.66, 0.74])
    return m


def build_ois_trades(model: Model, rng: np.random.Generator) -> list:
    """The 720 topology-distinct OIS (``bench.py:142-185``)."""
    value_dt = model.value_dt
    ois_defs = [  # (index, ccy, fixed dc, float dc)
        (CurveTypes.GBP_OIS_SONIA, CurrencyTypes.GBP,
         DayCountTypes.ACT_365F, DayCountTypes.ACT_365F),
        (CurveTypes.USD_OIS_SOFR, CurrencyTypes.USD,
         DayCountTypes.ACT_360, DayCountTypes.ACT_360),
        (CurveTypes.EUR_OIS_ESTR, CurrencyTypes.EUR,
         DayCountTypes.THIRTY_E_360, DayCountTypes.ACT_360),
        (CurveTypes.JPY_OIS_TONAR, CurrencyTypes.JPY,
         DayCountTypes.ACT_365F, DayCountTypes.ACT_365F),
        (CurveTypes.AUD_OIS_AONIA, CurrencyTypes.AUD,
         DayCountTypes.ACT_365F, DayCountTypes.ACT_365F),
        (CurveTypes.CAD_OIS_CORRA, CurrencyTypes.CAD,
         DayCountTypes.ACT_365F, DayCountTypes.ACT_365F),
    ]
    tenors = ["1Y", "2Y", "3Y", "5Y", "7Y", "10Y", "15Y", "20Y", "30Y",
              "50Y"]
    freqs = [FrequencyTypes.ANNUAL, FrequencyTypes.SEMI_ANNUAL,
             FrequencyTypes.QUARTERLY]
    bds = [BusDayAdjustTypes.MODIFIED_FOLLOWING,
           BusDayAdjustTypes.FOLLOWING]
    # 48 distinct start dates across ~4 years with day-of-month jitter
    month_offsets = [-40, -33, -27, -22, -18, -14, -11, -8, -6, -4,
                     -2, 0, 2, 5, 9, 14]
    starts = [value_dt.add_months(m).add_days(int(d))
              for m in month_offsets for d in (0, 7, 17)]

    trades = []
    i = 0
    for idx, ccy, fdc, ldc in ois_defs:
        for ten in tenors:
            for k in range(12):
                start = starts[(i * 7 + k) % len(starts)]
                trades.append(OIS(
                    start, ten,
                    SwapTypes.PAY if i % 2 else SwapTypes.RECEIVE,
                    float(rng.uniform(0.01, 0.06)),
                    freqs[i % len(freqs)], fdc, idx, ccy,
                    notional=float(rng.uniform(1e6, 2e7)),
                    float_dc_type=ldc,
                    payment_lag=i % 3,
                    bd_type=bds[k % 2]))
                i += 1
    return trades
