#!/usr/bin/env python3
"""Where K13's and K14's time goes on the card: each block's phases at a
flagship_v5 staged chunk's OIS stage.

    python3 scripts/ois_phases.py

Builds ``adrates_torch/csrc/ois_stage.cu`` again with ``-DOIS_TIMELINE``
(lane 0 of every block stamps the SM's clock at its phases, and K14's
warp 0 sums its cycles in its node band's two parts; the file's
``OIS_STAMP`` says which), builds flagship_v5 on its FLAT_FWD curves as
chip_smoke phase 7 does (100,400 trades, S = 100), captures K13's and
K14's arguments in one warm staged call (its first 50-scenario chunk:
G = 7, Qp = 32, 72 points, W = 2,225 rows; chip_smoke ``_capture_xccy``)
and launches the profiling build on them. Prints, for each kernel and
member, each phase's SM cycles (median and most over the scenarios) and
the slowest block's, in us at the card's most SM clock (nvidia-smi's
clocks.max.sm), the rows of each member that read its busiest node,
ptxas's registers and spills of the profiling build, its outputs against
the production build's (equal bit for bit) and the production build's
device time (a torch.profiler trace of 30 calls, chip_smoke
``_device_stats``), the card's name and power limit with every line; one
JSON line last. Needs one CUDA card and nvcc (about two minutes).
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
# each kernel's phases: (name, first stamp, last stamp) of OIS_STAMP
PHASES = {
    "ois_stage_jvp": (("quotes loaded", 0, 1), ("chain walked", 1, 2),
                      ("ds and dds written", 2, 3), ("rows written", 3, 4),
                      ("block", 0, 4)),
    "ois_stage_hess": (("quotes loaded", 0, 1), ("chain walked", 1, 2),
                       ("node band and B ds'", 2, 3), ("adjoint swept", 3, 4),
                       ("Hs written", 4, 5), ("block", 0, 5))}
# K14's warp 0's cycles in its node band's parts, summed over its chunks
SUMS = {"ois_stage_hess": (("node band: warp 0's rows' terms", 6),
                           ("node band: warp 0's run sums", 7))}
WHICH = {"ois_stage_jvp": 13, "ois_stage_hess": 14}


def _timeline_lib(kernels):
    """The profiling build: (library, what ptxas said of K13 and K14:
    registers and spill / stack bytes)."""
    src = kernels._CSRC / "ois_stage.cu"
    flags = [*kernels._NVCC_FLAGS, "-DOIS_TIMELINE"]
    h = hashlib.sha256((" ".join(flags)).encode() + src.read_bytes()
                       + (kernels._CSRC / "stage_rows.cuh").read_bytes())
    so = kernels._BUILD / f"libois_timeline_{h.hexdigest()[:16]}.so"
    kernels._BUILD.mkdir(parents=True, exist_ok=True)
    res = subprocess.run([kernels._nvcc(), *flags, "-Xptxas", "-v",
                          "-shared", "-o", str(so), str(src)],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(res.stderr)
    ptxas, name = {}, None
    for line in res.stderr.splitlines():
        if "Compiling entry" in line:
            name = next((k for k in ("k13_ois_stage_jvp",
                                     "k14_ois_stage_hess") if k in line),
                        None)
        elif name and ("registers" in line or "spill" in line):
            ptxas.setdefault(name, []).append(line.split(":", 1)[-1]
                                              .strip())
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in kernels._SIGNATURES.items():
        if fn.startswith("ois_"):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    lib.ois_timeline.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
    lib.ois_timeline.restype = ctypes.c_int
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
        print("ois_phases: no CUDA device visible", file=sys.stderr)
        return 2
    from adrates_torch.examples import flagship_v5 as cfg
    from adrates_torch.ops import kernels
    from adrates_torch.parallel.multibook import warmup_multibook
    kernels.build_kernels()
    dev = torch.device("cuda", 0)
    card = cs._card_line()
    model = cfg.build_model()
    with warnings.catch_warnings():            # CHF has no trades
        warnings.simplefilter("ignore", UserWarning)
        mb, shocks = cfg.build_book(model, np.random.default_rng(cfg.SEED))
    q0 = mb.basket.quotes0
    fn = warmup_multibook(mb, shocks.shape[0], dev, staged=True)
    args = cs._capture_xccy(lambda: fn(q0, shocks), names=cs.OIS)
    tab = args["ois_stage_jvp"][0]
    h = tab.host()
    busiest = [int(np.bincount(h["rq_i"][g, :, 0], minlength=tab.P1).max())
               for g in range(tab.G)]
    prod = {k: getattr(kernels, k)(*a) for k, a in args.items()}
    device = {k: cs._device_stats(lambda k=k: getattr(kernels, k)(*args[k]))
              for k in args}
    lib, ptxas = _timeline_lib(kernels)
    main_lib = kernels._lib
    kernels._lib = lib
    stamps, same = {}, {}
    try:
        for k, a in args.items():
            got = getattr(kernels, k)(*a)
            torch.cuda.synchronize()
            n = a[1].shape[0] * tab.G
            buf = (ctypes.c_longlong * (8 * n))()
            kernels._check(lib.ois_timeline(WHICH[k], ctypes.addressof(buf),
                                            n), "ois_timeline")
            stamps[k] = np.asarray(list(buf), dtype=np.int64).reshape(n, 8)
            ref = prod[k] if isinstance(prod[k], tuple) else (prod[k],)
            got = got if isinstance(got, tuple) else (got,)
            same[k] = all(torch.equal(x, y) for x, y in zip(got, ref))
    finally:
        kernels._lib = main_lib
    clock = subprocess.run(["nvidia-smi",
                            "--query-gpu=clocks.sm,clocks.max.sm",
                            "--format=csv,noheader,nounits"],
                           capture_output=True, text=True).stdout
    now, mhz = (float(x) for x in clock.split(",")) if clock else (
        float("nan"), float("nan"))
    out = {}
    for k, st in stamps.items():
        g_of = np.arange(st.shape[0]) % tab.G
        slow = int(np.argmax(st[:, PHASES[k][-1][2]] - st[:, 0]))
        span = [(name, st[:, b] - st[:, a]) for name, a, b in PHASES[k]] + [
            (name, st[:, i]) for name, i in SUMS.get(k, ())]
        rec = dict(slowest_block=dict(
            block=slow, member=int(g_of[slow]),
            phases={name: int(c[slow]) for name, c in span}), members={})
        for g in range(tab.G):
            rec["members"][g] = {name: dict(
                median=float(np.median(c[g_of == g])),
                most=int(c[g_of == g].max())) for name, c in span}
            print(f"{k} member {g} ({busiest[g]} rows on its busiest node):"
                  + "; ".join(f" {name} {v['median']:.0f} / {v['most']} "
                              f"cycles" for name, v in
                              rec["members"][g].items())
                  + f" (median / most over {int((g_of == g).sum())} "
                  f"scenarios); card "
                  f"{card}", flush=True)
        sb = rec["slowest_block"]
        print(f"{k} slowest block {sb['block']} (member {sb['member']}): "
              + "; ".join(f"{name} {c} cycles ({c / mhz:.1f} us)"
                          for name, c in sb["phases"].items())
              + f" at the most SM clock {mhz:g} MHz ({now:g} MHz just after "
              f"the launches); production device ms "
              f"{device[k] and device[k]['median']}; profiling build "
              f"{ptxas}; equal to the production build bit for bit: "
              f"{same[k]}; card {card}", flush=True)
        out[k] = rec
    print(json.dumps(dict(card=card, sm_mhz=mhz, sm_mhz_now=now,
                          shape=dict(Sc=int(args["ois_stage_jvp"][1]
                                            .shape[0]), G=tab.G, P=tab.P,
                                     Qp=tab.Qp, W=tab.W),
                          busiest_node_rows=busiest, kernels=out,
                          ptxas=ptxas, bit_for_bit=same,
                          device_ms={k: v and v["median"]
                                     for k, v in device.items()})))
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
