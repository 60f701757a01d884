#!/usr/bin/env python3
"""Where K12's time goes on the card: the phases of block 0 of each of its
two launches at flagship_v5's per-trade call.

    python3 scripts/k12_phases.py

Builds ``adrates_torch/csrc/xccy_stage.cu`` again with ``-DXCCY_TIMELINE``
(block 0 of each K12 launch stamps the SM's clock at its phases, lane 0 of
warps 0 and 1; ``k12_stamp`` says which), compiles flagship_v5's base book
on its FLAT_FWD curves (1,004 trades; its XCCY stage as the tiled book has
it: G = 3, S = 8, D = 48 recalibrated), captures K12's arguments in one
warm call of its first 256 trades' gammas (chip_smoke ``_capture_xccy``;
the stage's tensors are at the quotes alone, whichever trades)
and launches the profiling build on them. Prints each phase in SM cycles
and in us at the card's most SM clock (nvidia-smi's clocks.max.sm, beside
the clock it reads just after the launches), ptxas's registers and spills
of the profiling build, its outputs against the production build's (equal
bit for bit), and the production build's device time of each launch (a
torch.profiler trace of 30 calls, chip_smoke ``_device_stats``), the
card's name and power limit with every line; one JSON line last. Needs one
CUDA card and nvcc.
"""

import ctypes
import hashlib
import importlib.util
import json
import subprocess
import sys
import warnings
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
# (name, first stamp, last stamp, warp): the phases of block 0
PHASES = (("prologue: tables copied, grid transformed", 0, 1, 0),
          ("prologue: cum", 1, 2, 0),
          ("prologue: the primal chain's points", 2, 3, 0),
          ("prologue: the primal chain solved (warp 0)", 3, 4, 0),
          ("prologue: an item's points (warp 1)", 3, 4, 1),
          ("prologue: a dual chain's sums and pillars", 5, 6, 1),
          ("prologue: its ranks", 6, 7, 1),
          ("prologue: its nodes", 7, 8, 1),
          ("prologue: block 0", 0, 8, 1),
          ("pairs: tables copied", 10, 11, 0),
          ("pairs: a pair's points", 12, 13, 0),
          ("pairs: its sums and pillars", 13, 14, 0),
          ("pairs: its ranks", 14, 15, 0),
          ("pairs: its nodes", 15, 16, 0),
          ("pairs: its rows written", 16, 17, 0),
          ("pairs: block 0", 10, 17, 0))


def _timeline_lib(kernels):
    """The profiling build: (library, what ptxas said of K12's two
    kernels: registers and spill / stack bytes)."""
    src = kernels._CSRC / "xccy_stage.cu"
    flags = [*kernels._NVCC_FLAGS, "-DXCCY_TIMELINE"]
    h = hashlib.sha256((" ".join(flags)).encode() + src.read_bytes())
    so = kernels._BUILD / f"libxccy_timeline_{h.hexdigest()[:16]}.so"
    kernels._BUILD.mkdir(parents=True, exist_ok=True)
    res = subprocess.run([kernels._nvcc(), *flags, "-Xptxas", "-v",
                          "-shared", "-o", str(so), str(src)],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(res.stderr)
    ptxas, name = {}, None
    for line in res.stderr.splitlines():
        if "Compiling entry" in line:
            name = next((k for k in ("k12_node_prologue", "k12_node_pairs")
                         if k in line), None)
        elif name and ("registers" in line or "spill" in line):
            ptxas.setdefault(name, []).append(line.split(":", 1)[-1]
                                              .strip())
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in kernels._SIGNATURES.items():
        if fn.startswith("xccy_"):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    lib.k12_timeline.argtypes = [ctypes.c_void_p]
    lib.k12_timeline.restype = ctypes.c_int
    return lib, ptxas


def main() -> int:
    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sys.path.insert(0, str(HERE))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("k12_phases: no CUDA device visible", file=sys.stderr)
        return 2
    from adrates_torch.examples import flagship_v5 as cfg
    from adrates_torch.ops import kernels
    from adrates_torch.parallel import make_per_trade_gamma_fn
    kernels.build_kernels()
    dev = torch.device("cuda", 0)
    card = cs._card_line()
    model = cfg.build_model()
    trades, coll = cfg.build_base_trades(model,
                                         np.random.default_rng(cfg.SEED))
    with warnings.catch_warnings():            # CHF has no trades
        warnings.simplefilter("ignore", UserWarning)
        mb = cfg.compile_base(model, trades, coll, recalibrate_xccy=True)
    q0 = mb.basket.quotes0
    gam = make_per_trade_gamma_fn(mb, np.arange(min(256, mb.n_trades)),
                                  dev)
    gam(q0)
    args = cs._capture_xccy(lambda: gam(q0),
                            names=("xccy_stage_node_hess",))[
        "xccy_stage_node_hess"]
    tab = args[0]
    prod = kernels.xccy_stage_node_hess(*args)
    device = cs._device_stats(lambda: kernels.xccy_stage_node_hess(*args))
    lib, ptxas = _timeline_lib(kernels)
    main_lib = kernels._lib
    kernels._lib = lib
    try:
        got = kernels.xccy_stage_node_hess(*args)
        torch.cuda.synchronize()
        stamps = (ctypes.c_longlong * 64)()
        kernels._check(lib.k12_timeline(ctypes.addressof(stamps)),
                       "k12_timeline")
    finally:
        kernels._lib = main_lib
    same = all(torch.equal(a, b) for a, b in zip(got, prod)
               if a is not None)
    # the SM clock now, warm from the launches, and its most (us at it)
    clock = subprocess.run(["nvidia-smi",
                            "--query-gpu=clocks.sm,clocks.max.sm",
                            "--format=csv,noheader,nounits"],
                           capture_output=True, text=True).stdout
    now, mhz = (float(x) for x in clock.split(",")) if clock else (
        float("nan"), float("nan"))
    st = list(stamps)
    phases = {}
    for name, a, b, warp in PHASES:
        x, y = st[a + 32 * warp], st[b + 32 * warp]
        cyc = int(y - x) if x and y else None
        us = cyc / mhz if cyc is not None else None
        phases[name] = dict(cycles=cyc, us=us)
        print(f"K12 {name}: {cyc} cycles ({us} us at the most SM clock, "
              f"{mhz:g} MHz; {now:g} MHz just after the launches); card "
              f"{card}", flush=True)
    info = kernels.xccy_kernel_info(tab, "xccy_stage_node_hess")
    print(f"K12 profiling build: ptxas {ptxas}; outputs equal to the "
          f"production build's bit for bit: {same}; production device ms "
          f"a launch {device and device['by_name']}, a call "
          f"{device and device['median']}; {info}; card {card}",
          flush=True)
    print(json.dumps(dict(card=card, sm_mhz=mhz, sm_mhz_now=now,
                          phases=phases,
                          ptxas=ptxas, bit_for_bit=same, info=info,
                          device_ms=device and device["median"],
                          device_ms_by_launch=device
                          and device["by_name"])))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
