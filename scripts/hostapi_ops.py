#!/usr/bin/env python3
"""Count the torch ops of one warm call of each host-API path that
chip_smoke.py's phase 7e drives, on the CPU.

    python3 scripts/hostapi_ops.py

On flagship_v5's 32-pillar GBP_OIS_SONIA (FLAT_FWD_RATES): ``make_book_fn``
on the quick start's 20 OIS (the count does not depend on the number of
trades) under 100 N(0, 1e-3) shocks, ``scenario_grid`` of 100 shocks, and
``make_multibook_speed_fn`` on the GBP + USD OIS model (N = 64) with
their 240 flagship OIS. The count is ``staged_ops.leaf_ops``': the leaf
aten ops of a torch.profiler trace, views and metadata ops left out, a
host-side estimate of the kernels a call launches on a card.
"""

import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

from adrates_torch.examples import flagship_ois, flagship_v5, quickstart  # noqa: E402,E501
from adrates_torch.models import Model  # noqa: E402
from adrates_torch.parallel import (aggregate_book, compile_book,  # noqa: E402
                                    compile_multibook, make_book_fn,
                                    make_multibook_speed_fn)
from adrates_torch.utils import (CurrencyTypes, DayCountTypes,  # noqa: E402
                                 InterpTypes)
from staged_ops import leaf_ops  # noqa: E402


def main() -> int:
    model = flagship_v5.build_model()
    curve = model.curves.GBP_OIS_SONIA
    q = np.asarray(curve.swap_rates)
    book = compile_book(quickstart.book_swaps(np.random.default_rng(0)),
                        model.value_dt)
    agg = aggregate_book(book)
    shocks = np.random.default_rng(7).normal(0.0, 1e-3, (100, q.shape[0]))
    out = {}
    for want_gamma in (True, False):
        fn = make_book_fn(curve._plan, curve._interp_type,
                          want_gamma=want_gamma, device="cpu")
        fn(q, book, agg, shocks)
        out[f"make_book_fn(want_gamma={want_gamma})"] = leaf_ops(
            lambda: fn(q, book, agg, shocks))
    sg = np.random.default_rng(7).normal(0.0, 0.1, (100, q.shape[0]))
    model.scenario_grid("GBP_OIS_SONIA", sg, device="cpu")
    out["scenario_grid"] = leaf_ops(
        lambda: model.scenario_grid("GBP_OIS_SONIA", sg, device="cpu"))

    m2 = Model(model.value_dt)
    main_rates = flagship_ois.MAIN_RATES
    for name, px, dc in (("GBP_OIS_SONIA", main_rates,
                          DayCountTypes.ACT_365F),
                         ("USD_OIS_SOFR", [r + 0.35 for r in main_rates],
                          DayCountTypes.ACT_360)):
        m2.build_curve(name, px_list=px, tenor_list=flagship_ois.MAIN_TENORS,
                       fixed_dcc_type=dc, float_dc_type=dc,
                       interp_type=InterpTypes.FLAT_FWD_RATES)
    m2.build_fx(["GBPUSD"], [1.27])
    trades = [t for t in flagship_ois.build_ois_trades(
        model, np.random.default_rng(flagship_ois.SEED))
        if t._floating_index.name in m2.curves]
    mb = compile_multibook(trades, m2, base_currency=CurrencyTypes.USD)
    speed = make_multibook_speed_fn(mb, "cpu")
    speed(mb.basket.quotes0)
    out[f"make_multibook_speed_fn(N={mb.basket.n_quotes})"] = leaf_ops(
        lambda: speed(mb.basket.quotes0))
    print(f"leaf aten ops of one warm call: {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
