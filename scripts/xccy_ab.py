#!/usr/bin/env python3
"""The paths through the XCCY stages, for one checkout, on one CUDA
card: walls, device ops and device ms.

    python3 scripts/xccy_ab.py [ROOT]

ROOT is a checkout of this repository (default: the one holding this
script); its ``adrates_torch`` is imported and its kernels built. The
inputs and the timing helpers come from this checkout's
``chip_smoke.py``, so two checkouts are measured on the same inputs and
clocks. Measured, each as host-clock ms (median of 3 warm calls) and the
device ops and device ms of one warm call (a CUDA-only torch.profiler
trace), with K8-K11's device ms at each of their launches in that trace
(``kernel_ms``, by kernel name), the launches a call of K4 / K5 and
K8-K11 (those the checkout has) and the caching allocator's device
allocations over the timed calls:

- flagship_v5 on its FLAT_FWD curves (chip_smoke phase 7's book, S =
  100): the staged call, and regions A, C1 and C2 on its first
  50-scenario chunk, C2 once more with Python's garbage collector off;
- the OIS + XCCY book (chip_smoke phase 6's, S = 100): the staged call;
- flagship_v5's per-trade J pass at the quotes (``prep`` of
  ``make_per_trade_delta_fn``);
- K8-K11 alone at the arguments of their first call in a flagship_v5
  staged call (chip_smoke phase 8's captured inputs: the first
  50-scenario chunk; K9 / K11 on ``xccy_stage.probe_tables`` legs and
  seeded domestic tangents, as phase 8 takes them, since the book's own
  legs telescope to 0), 30 calls each by CUDA events and by profiler
  device time, with the worst error against their plain versions (abs /
  max|ref| over the outputs); K9 / K11 also on the captured tables and
  tangents unchanged (``*_alone_book``: the book's own legs, timed only).

Prints one JSON line. To compare commits, run parent, change, change,
parent in one call.
"""

import gc
import importlib.util
import json
import sys
import warnings
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
KERNELS = ("pv01_solve", "pv01_solve_t", "xccy_stage_jvp", "xccy_legs_jvp",
           "xccy_stage_hess", "xccy_legs_hess", "ois_stage_jvp",
           "ois_stage_hess")
# K8-K11's and K13 / K14's __global__ functions (the names the profiler's
# events carry)
XCCY_GLOBALS = ("k8_stage_jvp", "k9_legs_jvp", "k10_stage_hess",
                "k11_legs_hess", "k13_ois_stage_jvp", "k14_ois_stage_hess")


def trace(f):
    """(device ops, their summed device ms, {K8-K11 / K13-K14 kernel:
    [device ms of each launch]}) of one warm ``f()`` call in a CUDA-only torch.profiler
    trace; (None, None, {}) when the trace holds no device event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    f()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        f()
        torch.cuda.synchronize()
    ks = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not ks:
        return None, None, {}
    split = {k: [e.time_range.elapsed_us() / 1e3 for e in ks
                 if k in e.name] for k in XCCY_GLOBALS}
    return (len(ks), sum(e.time_range.elapsed_us() for e in ks) / 1e3,
            {k: v for k, v in split.items() if v})


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
        print("xccy_ab: no CUDA device visible", file=sys.stderr)
        return 2
    import adrates_torch
    if root not in Path(adrates_torch.__file__).resolve().parents:
        raise AssertionError(f"imported {adrates_torch.__file__}, not from "
                             f"{root}")
    from adrates_torch.examples import flagship_ois_xccy as xcfg
    from adrates_torch.examples import flagship_v5 as cfg
    from adrates_torch.ops import kernels
    from adrates_torch.parallel import make_per_trade_delta_fn
    from adrates_torch.parallel.multibook import warmup_multibook
    kernels.build_kernels()
    dev = torch.device("cuda", 0)
    names = [k for k in KERNELS if hasattr(kernels, k)]

    def launches():
        return {k: getattr(kernels, k).launches for k in names}

    def measure(f, n=3):
        f()
        before = launches()
        mallocs = torch.cuda.memory_stats(dev).get("num_device_alloc", 0)
        w = cs._stats([cs._timed(f)[1] for _ in range(n)])
        mallocs = torch.cuda.memory_stats(dev).get("num_device_alloc",
                                                   0) - mallocs
        ls = {k: (v - before[k]) / n for k, v in launches().items()}
        ops, dms, split = trace(f)
        return dict(warm_ms=w, device_ops=ops, device_ms=dms,
                    kernel_ms=split, launches_per_call=ls,
                    device_mallocs=mallocs)

    out = dict(root=str(root), card=cs._card_line(),
               torch=torch.__version__)
    model = cfg.build_model()
    with warnings.catch_warnings():        # CHF has no trades
        warnings.simplefilter("ignore", UserWarning)
        mb, shocks = cfg.build_book(model, np.random.default_rng(cfg.SEED))
    q0 = mb.basket.quotes0
    fn = warmup_multibook(mb, shocks.shape[0], dev, staged=True)
    out["staged"] = measure(lambda: fn(q0, shocks))
    alone = cs._capture_xccy(lambda: fn(q0, shocks))
    from adrates_torch.ops import xccy_stage as xs
    for k, name in enumerate(cs.XCCY):
        args = list(alone[name])
        if name in ("xccy_legs_jvp", "xccy_legs_hess"):
            args[0] = xs.probe_tables(args[0], 31 + k)
            args[2] = torch.as_tensor(1e-3 * np.random.default_rng(
                41 + k).standard_normal(tuple(args[2].shape)),
                device=args[1].device)
        kern = getattr(kernels, name)
        got = [r for r in kern(*args) if r is not None]
        ref = [r for r in getattr(xs, name + "_plain")(*args)
               if r is not None]
        err = max(float((a - b).abs().max() / b.abs().max())
                  for a, b in zip(got, ref))
        dv = cs._device_stats(lambda: kern(*args))
        out[f"{name}_alone"] = dict(
            ms=cs._cuda_ms(lambda: kern(*args)),
            device_ms=dv and dv["median"], device_ms_min=dv and dv["min"],
            device_ms_max=dv and dv["max"], max_rel_err=err,
            scenarios=args[1].shape[0])
        del got, ref
        if name in ("xccy_legs_jvp", "xccy_legs_hess"):
            args = list(alone[name])
            dv = cs._device_stats(lambda: kern(*args))
            out[f"{name}_alone_book"] = dict(
                ms=cs._cuda_ms(lambda: kern(*args)),
                device_ms=dv and dv["median"],
                device_ms_min=dv and dv["min"],
                device_ms_max=dv and dv["max"],
                scenarios=args[1].shape[0])
    del alone
    chunk = fn.chunk(shocks.shape[0])
    q = torch.as_tensor(q0, device=dev)[None, :] \
        + torch.as_tensor(shocks[:chunk], device=dev)
    r = fn.regions
    a = r["A"](q)
    _, v_of = r["C1"](q, a["g"], a["carry"])
    for name, f in (("A", lambda: r["A"](q)),
                    ("C1", lambda: r["C1"](q, a["g"], a["carry"])),
                    ("C2", lambda: r["C2"](q, a["g"], v_of))):
        out[f"region_{name}"] = dict(measure(f), chunk=chunk)
    gc.disable()
    try:
        out["region_C2_no_gc"] = dict(
            measure(lambda: r["C2"](q, a["g"], v_of)), chunk=chunk)
    finally:
        gc.enable()
    del a, v_of, fn
    lad = make_per_trade_delta_fn(mb, dev)
    out["pertrade_prep"] = measure(lambda: lad.prep(q0))
    del lad, mb

    rng = np.random.default_rng(xcfg.SEED)
    model = xcfg.build_model()
    base, coll = xcfg.build_trades(model, rng)
    scale = rng.uniform(0.5, 2.0, xcfg.N_TRADES // len(base))
    mb = cs._compile(model, base, scale, collateral_types=coll)
    shocks = rng.normal(0.0, 1e-3, (xcfg.N_SCENARIOS, mb.basket.n_quotes))
    fn = warmup_multibook(mb, shocks.shape[0], dev, staged=True)
    out["ois_xccy_staged"] = measure(lambda: fn(mb.basket.quotes0, shocks))
    torch.cuda.synchronize()
    print(json.dumps(out))
    summary = {k: (round(v["warm_ms"]["median"], 1), v["device_ops"],
                   v["device_ms"] and round(v["device_ms"], 2))
               if "warm_ms" in v else (round(v["ms"], 4),
                                       v["device_ms"]
                                       and round(v["device_ms"], 4))
               for k, v in out.items() if isinstance(v, dict)}
    print(f"xccy_ab {root.name}: (warm median ms, device ops, device ms) "
          f"{summary}; card {out['card']}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
