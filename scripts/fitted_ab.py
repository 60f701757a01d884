#!/usr/bin/env python3
"""The spline cell's paths, where the fitted-scheme rows sit, for one
checkout, on one CUDA card: walls, device ops and device ms.

    python3 scripts/fitted_ab.py [ROOT]

ROOT is a checkout of this repository (default: the one holding this
script); its ``adrates_torch`` is imported and its kernels built. The
inputs and the timing helpers come from this checkout's
``chip_smoke.py``, so two checkouts are measured on the same inputs and
clocks. Measured on flagship_v5 with ``SPLINE_SCHEMES`` (chip_smoke
7d's book, S = 100):

- the staged call: host-clock ms (median of 3 warm) and the device ops
  and device ms of one warm call (a CUDA-only torch.profiler trace);
- regions A, C1 and C2 on the first 50-scenario chunk, the same;
- the 256 selected trades' dense gammas (``make_per_trade_gamma_fn``),
  the same;
- on flagship_v5's own FLAT_FWD curves (chip_smoke phase 7b's book):
  the 256 dense gammas and every trade's own-block gamma
  (``make_per_trade_gamma_blocks_fn``), the same;
- the launches of K4 / K5, K6 / K7 and K8-K11 in each (those the
  checkout has);
- in each region, the device ops (and their ms) launched inside the
  calls of ``ops/fitted_rows.fitted_eval`` (wrapped in a
  ``record_function`` where ``curve_batching`` and ``interpolation``
  call it; each device event placed by its launch's correlation id in
  one traced warm call): all of a call's work in region A, whose
  derivatives are forward mode, the forward and tangent side alone in
  C1 and C2.

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
           "xccy_stage_hess", "xccy_legs_hess")


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
        print("fitted_ab: no CUDA device visible", file=sys.stderr)
        return 2
    import adrates_torch
    if root not in Path(adrates_torch.__file__).resolve().parents:
        raise AssertionError(f"imported {adrates_torch.__file__}, not from "
                             f"{root}")
    from adrates_torch.examples import flagship_v5 as cfg
    from adrates_torch.ops import kernels
    from adrates_torch.parallel import (make_per_trade_gamma_blocks_fn,
                                        make_per_trade_gamma_fn)
    from adrates_torch.parallel.multibook import warmup_multibook
    kernels.build_kernels()
    dev = torch.device("cuda", 0)
    names = [k for k in KERNELS if hasattr(kernels, k)]

    def launches():
        return {k: getattr(kernels, k).launches for k in names}

    def measure(f, n=3):
        f()
        before = launches()
        w = cs._stats([cs._timed(f)[1] for _ in range(n)])
        ls = {k: v - before[k] for k, v in launches().items()}
        ops, dms = cs._request_device(f)
        return dict(warm_ms=w, device_ops=ops, device_ms=dms, launches=ls,
                    calls=n)

    def inside_fitted(f):
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile, record_function

        from adrates_torch.ops import interpolation as ip
        from adrates_torch.parallel import curve_batching as cb
        orig = {m: m.fitted_eval for m in (cb, ip)}

        def wrap(g):
            def h(*a):
                with record_function("_fitted_eval_call"):
                    return g(*a)
            return h
        for m, g in orig.items():
            m.fitted_eval = wrap(g)
        try:
            f()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                f()
                torch.cuda.synchronize()
        finally:
            for m, g in orig.items():
                m.fitted_eval = g
        ev = prof.events()
        wins = [(e.time_range.start, e.time_range.end) for e in ev
                if e.device_type == DeviceType.CPU
                and e.name == "_fitted_eval_call"]
        launch = {e.id: (e.time_range.start + e.time_range.end) / 2
                  for e in ev if e.device_type == DeviceType.CPU
                  and e.name.startswith("cu")}
        ops, us = 0, 0.0
        for e in ev:
            at = launch.get(e.id)
            if e.device_type != DeviceType.CUDA or at is None \
                    or e.name.startswith("_fitted_eval_call"):
                continue
            if any(a <= at <= b for a, b in wins):
                ops += 1
                us += e.time_range.elapsed_us()
        return dict(device_ops=ops, device_ms=us / 1e3, calls=len(wins))

    model = cfg.build_model(schemes=cfg.SPLINE_SCHEMES)
    with warnings.catch_warnings():        # CHF has no trades
        warnings.simplefilter("ignore", UserWarning)
        mb, shocks = cfg.build_book(model, np.random.default_rng(cfg.SEED))
    q0 = mb.basket.quotes0
    out = dict(root=str(root), card=cs._card_line(),
               torch=torch.__version__)
    fn = warmup_multibook(mb, shocks.shape[0], dev, staged=True)
    out["staged"] = measure(lambda: fn(q0, shocks))
    chunk = fn.chunk(shocks.shape[0])
    q = torch.as_tensor(q0, device=dev)[None, :] \
        + torch.as_tensor(shocks[:chunk], device=dev)
    r = fn.regions
    a = r["A"](q)
    _, v_of = r["C1"](q, a["g"], a["carry"])
    for name, f in (("A", lambda: r["A"](q)),
                    ("C1", lambda: r["C1"](q, a["g"], a["carry"])),
                    ("C2", lambda: r["C2"](q, a["g"], v_of))):
        out[f"region_{name}"] = dict(measure(f), chunk=chunk,
                                     inside_fitted_eval=inside_fitted(f))
    del a, v_of, fn
    g = make_per_trade_gamma_fn(mb, cs._select_trades(mb)[0], dev)
    out["gamma_256"] = measure(lambda: g(q0))
    del g, mb
    model = cfg.build_model()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        mb, _ = cfg.build_book(model, np.random.default_rng(cfg.SEED))
    q0 = mb.basket.quotes0
    g = make_per_trade_gamma_fn(mb, cs._select_trades(mb)[0], dev)
    out["flat_gamma_256"] = measure(lambda: g(q0))
    del g
    blk = make_per_trade_gamma_blocks_fn(mb, dev)
    out["flat_blocks"] = measure(lambda: blk(q0))
    torch.cuda.synchronize()
    print(json.dumps(out))
    summary = {k: (round(v["warm_ms"]["median"], 1), v["device_ops"])
               + ((v["inside_fitted_eval"]["device_ops"],)
                  if "inside_fitted_eval" in v else ())
               for k, v in out.items() if isinstance(v, dict)}
    print(f"fitted_ab {root.name}: (warm median ms, device ops[, of them "
          f"inside fitted_eval calls]) "
          f"{summary}; card {out['card']}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
