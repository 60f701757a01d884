#!/usr/bin/env python3
"""The per-trade second-order paths of flagship_v5 for one checkout, on
one CUDA card: walls, device ops, device ms and kernel launches.

    python3 scripts/pertrade_ab.py [ROOT]

ROOT is a checkout of this repository (default: the one holding this
script); its ``adrates_torch`` is imported and its kernels built. The
inputs and the timing helpers come from this checkout's
``chip_smoke.py``, so two checkouts are measured on the same inputs and
clocks. Measured, each cold + 3 warm (host-clock ms, median of the warm
calls) with the device ops and device ms of one more warm call (a
CUDA-only torch.profiler trace) and the launches of K4 / K5, K6 / K7 and
K8-K12 over the warm calls (those the checkout has):

- flagship_v5 on its FLAT_FWD curves (chip_smoke phase 7b's book): the
  256 selected trades' dense gammas (``make_per_trade_gamma_fn``) and
  every trade's own-block gamma (``make_per_trade_gamma_blocks_fn``);
- flagship_v5 on ``SPLINE_SCHEMES`` (phase 7d's book): the 256 gammas.

Prints one JSON line. To compare commits, run parent, change, change,
parent in one call.
"""

import importlib.util
import json
import sys
import warnings
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
KERNELS = ("pv01_solve", "pv01_solve_t", "fitted_eval", "fitted_eval_jvp",
           "fitted_rows", "fitted_rows_t", "xccy_stage_jvp", "xccy_legs_jvp",
           "xccy_stage_hess", "xccy_legs_hess", "xccy_stage_node_hess")


def main(argv) -> int:
    root = Path(argv[1] if len(argv) > 1 else HERE).resolve()
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("pertrade_ab: no CUDA device visible", file=sys.stderr)
        return 2
    import adrates_torch
    if root not in Path(adrates_torch.__file__).resolve().parents:
        raise AssertionError(f"imported {adrates_torch.__file__}, not from "
                             f"{root}")
    from adrates_torch.examples import flagship_v5 as cfg
    from adrates_torch.ops import kernels
    from adrates_torch.parallel import (make_per_trade_gamma_blocks_fn,
                                        make_per_trade_gamma_fn)
    kernels.build_kernels()
    dev = torch.device("cuda", 0)
    names = [k for k in KERNELS if hasattr(kernels, k)]

    def launches():
        return {k: getattr(kernels, k).launches for k in names}

    def measure(f, n=3):
        cold = cs._timed(f)[1]
        before = launches()
        w = cs._stats([cs._timed(f)[1] for _ in range(n)])
        ls = {k: v - before[k] for k, v in launches().items()}
        ops, dms = cs._request_device(f)
        return dict(cold_ms=cold, warm_ms=w, device_ops=ops, device_ms=dms,
                    launches=ls, calls=n)

    out = dict(root=str(root), card=cs._card_line(),
               torch=torch.__version__)
    for key, schemes in (("flat", None), ("spline", cfg.SPLINE_SCHEMES)):
        model = cfg.build_model(schemes=schemes)
        with warnings.catch_warnings():        # CHF has no trades
            warnings.simplefilter("ignore", UserWarning)
            mb, _ = cfg.build_book(model, np.random.default_rng(cfg.SEED))
        q0 = mb.basket.quotes0
        g = make_per_trade_gamma_fn(mb, cs._select_trades(mb)[0], dev)
        out[f"{key}_gamma_256"] = measure(lambda: g(q0))
        del g
        if key == "flat":
            blk = make_per_trade_gamma_blocks_fn(mb, dev)
            out["flat_blocks"] = measure(lambda: blk(q0))
            del blk
        del mb
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    print(json.dumps(out))
    summary = {k: (round(v["warm_ms"]["median"], 1), v["device_ops"],
                   round(v["device_ms"], 2) if v["device_ms"] else None)
               for k, v in out.items() if isinstance(v, dict)}
    print(f"pertrade_ab {root.name}: (warm median ms, device ops, device "
          f"ms) {summary}; card {out['card']}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
