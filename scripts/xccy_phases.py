#!/usr/bin/env python3
"""Where K8-K11's time goes on the card: a per-block timeline at
flagship_v5's XCCY stage.

    python3 scripts/xccy_phases.py

Builds ``adrates_torch/csrc/xccy_stage.cu`` again with ``-DXCCY_TIMELINE``
(each block of K8 ``xccy_stage_jvp`` and K10 ``xccy_stage_hess`` stamps
the global timer at its start, after its tables are loaded, after its
dual chains, after the rows' sums (K10) and at its end; each block of K9
``xccy_legs_jvp`` and K11 ``xccy_legs_hess`` after its grid, tangent
rows and value DFs are loaded, after its flows and their segments' sums,
after the targets' sums and gradients (K11: and gdd) and at its end,
the dots; each with its SM), warms flagship_v5 on its FLAT_FWD curves on
the staged path (chip_smoke phase 7's book, S = 100), captures K8-K11's
arguments at their first call (the first 50-scenario chunk, chip_smoke
``_capture_xccy``; K9 / K11 on ``xccy_stage.probe_tables`` legs and
seeded tangents, as phase 8 takes them) and launches the profiling
build's entry points on them. Prints, per
kernel and kind of block (the last block of a (scenario, member), which
takes K10's foreign grid entries, and the others), the median and the
largest time of each phase a block, the launch's span, the blocks each
SM ran and the average number of blocks in flight an SM (the sum of the
blocks' times over the span, over the SMs), the build's device time
(profiler, 30 calls) and what ptxas said of its registers and spills,
beside the production build's device and events time; checks that the
profiling build's outputs equal the production build's bit for bit. The card's name and
power limit go with every line; a JSON line last. Needs one CUDA card
and nvcc.
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
PHASES = ("load", "chains", "sums", "pairs_or_rows")
LEG_PHASES = ("load", "flows", "sums", "dots")


def _timeline_lib(kernels):
    """The profiling build: (library, what ptxas said of K8 and K10:
    registers and spill / stack bytes)."""
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
        for k in ("k8_stage_jvp", "k9_legs_jvp", "k10_stage_hess",
                  "k11_legs_hess"):
            if "Compiling entry" in line and k in line:
                name = k
        if name and ("registers" in line or "spill" in line):
            ptxas.setdefault(name, []).append(line.split(":", 1)[-1]
                                              .strip())
    lib = ctypes.CDLL(str(so))
    for name, argtypes in kernels._SIGNATURES.items():
        if name.startswith("xccy_"):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
    lib.xccy_timeline.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.xccy_timeline.restype = ctypes.c_int
    return lib, ptxas


def _summary(stamps, kinds, phases=PHASES):
    import numpy as np
    out = {}
    start, end = stamps[:, 0].min(), stamps[:, 4].max()
    span = (end - start) / 1e3
    for kind in sorted(set(kinds)):
        s = stamps[np.asarray(kinds) == kind]
        d = np.diff(s[:, :5], axis=1) / 1e3                     # us
        tot = (s[:, 4] - s[:, 0]) / 1e3
        out[kind] = dict(
            blocks=int(s.shape[0]),
            median_us={p: float(np.median(d[:, k]))
                       for k, p in enumerate(phases)},
            max_us={p: float(d[:, k].max()) for k, p in enumerate(phases)},
            block_median_us=float(np.median(tot)),
            block_max_us=float(tot.max()),
            first_start_us=float((s[:, 0].min() - start) / 1e3),
            last_start_us=float((s[:, 0].max() - start) / 1e3))
    sms = stamps[:, 5].astype(int)
    busy = np.bincount(sms, weights=(stamps[:, 4] - stamps[:, 0]) / 1e3)
    per_sm = np.bincount(sms)
    live = per_sm > 0
    out["span_us"] = float(span)
    out["sms"] = int(live.sum())
    out["blocks_per_sm"] = [int(per_sm[live].min()), int(per_sm[live].max())]
    out["in_flight_per_sm"] = float(busy[live].mean() / span)
    return out


def _info(lib, kernels, tab, name):
    out = (ctypes.c_int * 8)()
    k = kernels._XCCY_KERNEL[name]
    kernels._check(lib.xccy_kernel_info(
        kernels._xstage(tab), tab.Qd if k in (9, 11) else tab.D, k,
        int(tab.recal), out), "xccy_kernel_info")
    return dict(registers=out[0], local_bytes=out[1], smem_bytes=out[2],
                blocks_per_sm=out[3], tile=out[5], per=out[7])


def _run(cs, kernels, lib, name, args, dev):
    """Launch the profiling build's ``name`` on the captured ``args``:
    (its outputs, the timeline summary, its device ms)."""
    import numpy as np
    import torch
    tab = args[0]
    info = _info(lib, kernels, tab, name)
    Sc, G, D, Qd = args[1].shape[0], tab.G, tab.D, tab.Qd
    per = info["per"]
    stream = kernels._stream(dev)
    st = kernels._xstage(tab)
    phases = PHASES

    def ptr(t):
        return None if t is None else t.data_ptr()
    if name in ("xccy_legs_jvp", "xccy_legs_hess"):
        phases = LEG_PHASES
        dd, tdl = args[1:3]
        if name == "xccy_legs_jvp":
            got = [torch.empty((Sc, G, tab.S), dtype=torch.float64,
                               device=dev),
                   torch.empty((Sc, Qd, G, tab.S), dtype=torch.float64,
                               device=dev)]

            def launch():
                kernels._check(lib.xccy_legs_jvp_f64(
                    st, Sc, Qd, ptr(dd), ptr(tdl),
                    *[g.data_ptr() for g in got], stream), name)
        else:
            got = [torch.empty((Sc, G, tab.Ld), dtype=torch.float64,
                               device=dev),
                   torch.empty((Sc, Qd, G, Qd), dtype=torch.float64,
                               device=dev)]

            def launch():
                kernels._check(lib.xccy_legs_hess_f64(
                    st, Sc, Qd, tab.Ld, ptr(dd), ptr(tdl), ptr(args[3]),
                    *[g.data_ptr() for g in got], stream), name)
    elif name == "xccy_stage_jvp":
        sp, pv, fd, tf = args[1:5]
        got = [torch.empty((Sc, G, tab.U1), dtype=torch.float64,
                           device=dev),
               torch.empty((Sc, G, tab.W), dtype=torch.float64, device=dev),
               torch.empty((Sc, D, G, tab.W), dtype=torch.float64,
                           device=dev)]

        def launch():
            kernels._check(lib.xccy_stage_jvp_f64(
                st, Sc, D, tab.npv, ptr(sp), ptr(pv), ptr(fd), ptr(tf),
                *[g.data_ptr() for g in got], stream), name)
    else:
        sp, pv, fd, tf = args[1:5]
        got = [torch.empty((Sc, G, D), dtype=torch.float64, device=dev),
               torch.empty((Sc, G, tab.Lf), dtype=torch.float64,
                           device=dev),
               torch.empty((Sc, D, G, D), dtype=torch.float64, device=dev)]
        n_gf = tab.Lf if tab.recal else 0

        def launch():
            kernels._check(lib.xccy_stage_hess_f64(
                st, Sc, D, tab.npv, n_gf, ptr(sp), ptr(pv), ptr(fd),
                ptr(tf), args[5].data_ptr(),
                *[g.data_ptr() for g in got], stream), name)
    launch()
    launch()
    torch.cuda.synchronize()
    n = Sc * G * per
    buf = np.zeros((n, 6), dtype=np.uint64)
    kernels._check(lib.xccy_timeline(buf.ctypes.data, n), "timeline")
    kinds = ["last" if b % per == per - 1 else "blocks" for b in range(n)]
    summ = _summary(buf.astype(np.int64), kinds, phases)
    dv = cs._device_stats(launch)
    if name == "xccy_stage_hess" and not tab.recal:
        got[1] = None
    return got, dict(timeline=summ, blocks=n, info=info,
                     device_ms=dv and dv["median"])


def main() -> int:
    sys.path.insert(0, str(HERE))
    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("xccy_phases: no CUDA device visible", file=sys.stderr)
        return 2
    from adrates_torch.examples import flagship_v5 as cfg
    from adrates_torch.ops import kernels
    from adrates_torch.parallel.multibook import warmup_multibook
    kernels.build_kernels()
    lib, ptxas = _timeline_lib(kernels)
    dev = torch.device("cuda", 0)
    card = cs._card_line()
    model = cfg.build_model()
    with warnings.catch_warnings():        # CHF has no trades
        warnings.simplefilter("ignore", UserWarning)
        mb, shocks = cfg.build_book(model, np.random.default_rng(cfg.SEED))
    fn = warmup_multibook(mb, shocks.shape[0], dev, staged=True)
    cap = cs._capture_xccy(lambda: fn(mb.basket.quotes0, shocks))
    out = dict(card=card)
    from adrates_torch.ops import xccy_stage as xs
    for k, name in enumerate(cs.XCCY):
        args = list(cap[name])
        if name in ("xccy_legs_jvp", "xccy_legs_hess"):
            args[0] = xs.probe_tables(args[0], 31 + k)
            args[2] = torch.as_tensor(1e-3 * np.random.default_rng(
                41 + k).standard_normal(tuple(args[2].shape)), device=dev)
        kern = getattr(kernels, name)
        ref = [r for r in kern(*args) if r is not None]
        dv = cs._device_stats(lambda: kern(*args))
        out[name] = dict(production=dict(
            device_ms=dv and dv["median"],
            ms=cs._cuda_ms(lambda: kern(*args)),
            info=kernels.xccy_kernel_info(args[0], name)))
        print(f"xccy_phases {name} production: {out[name]['production']}; "
              f"card {card}", flush=True)
        got, rec = _run(cs, kernels, lib, name, args, dev)
        rec["ptxas"] = ptxas
        rec["equal_to_production_bit_for_bit"] = all(
            torch.equal(a, b) for a, b in
            zip([g for g in got if g is not None], ref))
        out[name]["timeline"] = rec
        print(f"xccy_phases {name} timeline build: {json.dumps(rec)}; card "
              f"{card}", flush=True)
        if not rec["equal_to_production_bit_for_bit"]:
            raise AssertionError(f"{name}: the profiling build differs from "
                                 f"the production one")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
