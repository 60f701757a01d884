#!/usr/bin/env python3
"""Where K7's time goes on the card: ``fitted_rows_t`` built with parts
cut out or changed, at the spline cell's K7 calls.

    python3 scripts/k7_phases.py [ROOT] [--inputs FILE] [--variants NAME ...]

ROOT is a checkout of this repository (default: the one holding this
script). Its ``adrates_torch/csrc/fitted_rows.cu`` is compiled into
scratch libraries under ``adrates_torch/_build/`` of this checkout,
once as it is and once for each variant made by text patches; a
variant whose patch targets the source lacks is skipped (the parent's
and this design's variants differ). The parent's design (a warp's
segmented shuffle scan over the queries in interval order):
``no_scan`` (each lane adds its own products; racy sums, a timing
probe), ``live_rows`` (the scan skips a warp's dead row slots; exact),
``no_smem_adds`` (the sums kept, the shared read-add-writes behind a
test no sum passes), ``no_solve`` (no spline T^-T sweeps),
``loads_only`` (none of those three), ``no_queries`` (no query loop: the
zeroing, the solve and the stores). This design (the cotangents
streamed through shared memory, summed over static segments):
``no_segments`` (the loads and the combination, no segment sums),
``no_combine`` (the segment sums, their combination behind a test no sum
passes), ``no_solve``, ``loads_only`` (neither sums nor solve),
``no_queries`` (no chunk loop), ``timeline`` (a per-block timeline
of global-timer stamps), ``steps`` (one chunk's steps in clock cycles),
``stages_more`` (a ring of 3 stages at 8-row tiles, two blocks
an SM, 4 below), ``no_carveout`` (the driver's default split of L1 and
shared memory), ``no_unroll`` (the segment loop not unrolled),
``tile4`` / ``tile2`` (at most 4 or 2 rows a tile).

The calls (``--inputs``, a file written by the first run that finds it
missing and read by the later ones, so that every checkout sees the same
tables): the spline cell (flagship_v5 on ``SPLINE_SCHEMES``, chip_smoke
7d's book) warmed on its staged path, then K7's largest call in regions
C2 and C1 of one 50-scenario chunk and in the 256 dense gammas
(chip_smoke ``_capture_fitted`` / ``_watch_fitted``), kept as each
call's shape and its members' knots, queries, brackets and kinds. Each
checkout rebuilds its own tables from them with its own
``kernels.fitted_tables``.

Each call runs on standard normal cotangents (seed 16). The checkout's
wrapper ``kernels.fitted_rows_t`` is run once with its library replaced
by a recorder, which keeps the arguments it passes to the C entry
point; each variant is then launched with those arguments and its
output checked against the checkout's plain twin (1e-12 x max|ref|,
and bit for bit against the unpatched kernel where the variant keeps
the arithmetic). Times: CUDA events around 30 back-to-back launches of
the bare entry point divided by 30 (``ms``), and the kernel's device
time in a torch.profiler trace of 30 launches (``device_ms``, chip_smoke
``_device_stats``); beside them, once a call, one ``torch.bmm`` of the
cotangents by the members' dense operators (the yardstick). Prints each
variant's registers and shared memory (``nvcc -Xptxas -v``), one line a
measurement with the card's name and power limit, and a JSON line last.
Beside the ``full`` variant, each call also runs that library's K6
(``fitted_rows``) at the transposed shape on standard normal X (seed
17) and prints its device time and a digest of its output, so that two
checkouts' K6 can be held equal bit for bit. Needs one CUDA card and
nvcc. To compare two checkouts, run parent, change, change, parent in
one call with one ``--inputs`` file.
"""

import argparse
import ctypes
import hashlib
import importlib.util
import json
import subprocess
import sys
import warnings
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
ENTRY = "fitted_rows_t_f64"
CALLS = (("C2", "fitted_rows_t"), ("C1", "fitted_rows_t"),
         ("gamma_256", "fitted_rows_t"))

# the parent's design: a warp's segmented shuffle scan
_SCAN = "    for (int off = 1; off < 32; off <<= 1) {\n"
_LAST = "    const bool last = live && (lane == 31 || jn != j);\n"
_ADDS = "    if (last) {\n"
_SCAN_ROWS = """#pragma unroll
      for (int q = 0; q < kRowsWarp; ++q) {
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const double t = __shfl_up_sync(0xffffffffu, p[q][m], off);
"""
_SOLVE_T = ("  if (kd != 0) {\n    if ((int)threadIdx.x < rows) {\n"
            "      double* z = db")
_QUERIES = "  for (int k0 = 0; k0 < W; k0 += 32) {\n"
# this design: segments streamed through shared memory
_SEG_PASS = ("    for (int it = threadIdx.x; sums && it < nseg * rows; "
             "it += kThreads) {\n")
_COMBINE = ("      yb[r * ld + i] += ty;\n"
            "      db[r * ld + i] += td;\n")
_CHUNKS = "  for (int c = 0; c < nch; ++c) {\n"
_SOLVE_N = "  if (kd != 0) {  // T^-T, one lane a row\n"
_STAGES = "  return tr >= 8 ? 2 : tr >= 4 ? 3 : 4;"
_TILE = "  const int tr = fit_t_tile(R, G, n_max, nc);\n"

_NEVER = "-7.25e-300"                 # a value no sum takes
_PARENT_SOLVE = (_SOLVE_T, _SOLVE_T.replace("kd != 0", "kd == -1"))
_SOLVE = (_SOLVE_N, _SOLVE_N.replace("kd != 0", "kd == -1"))
_NO_SEGS = (_SEG_PASS, _SEG_PASS.replace("it < nseg * rows", "it < 0"))
_NO_CMB = (_COMBINE,
           f"      if (ty == {_NEVER}) {{\n" + _COMBINE + "      }\n")
_NO_SCAN = (_SCAN, "    for (int off = 1; off < 1; off <<= 1) {\n")
_NO_ADDS = (_ADDS, f"    if (last && p[0][0] == {_NEVER}) {{\n")
# a per-block timeline (this design): thread 0 stamps the global timer
# at the block's start (slot 0), once the chunk table is read (1), as
# each of the first ten chunks has landed (2-11), after the chunks (12),
# after the solve (13) and after the stores (14), and its SM (15); the
# block writes its 16 slots over the input (read by then by every block
# that reads that part; the script restores it after)
_STAMP = """
  __shared__ unsigned long long tls[16];
  auto stamp = [&](int i) {
    if (threadIdx.x == 0 && i < 15) {
      unsigned long long t;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
      tls[i] = t;
    }
  };
  if (threadIdx.x == 0)
    for (int i = 0; i < 16; ++i) tls[i] = 0;
  stamp(0);
"""
_STORE_END = ("    if (K == 2) xr[n_max + i] = vd;\n  }\n}\n")
_TIMELINE = [
    ("  extern __shared__ __align__(16) double tsm[];\n",
     "  extern __shared__ __align__(16) double tsm[];\n" + _STAMP),
    ("  __syncthreads();                          // chs, the barriers\n",
     "  __syncthreads();                          // chs, the barriers\n"
     "  stamp(1);\n"),
    ("    __syncthreads();                        // (everyone's)\n",
     "    __syncthreads();                        // (everyone's)\n"
     "    stamp(c < 10 ? 2 + c : 15);\n"),
    ("  cp_async_wait<0>();\n  __syncthreads();\n",
     "  cp_async_wait<0>();\n  __syncthreads();\n  stamp(12);\n"),
    ("  // 4. store", "  stamp(13);\n  // 4. store"),
    (_STORE_END, "    if (K == 2) xr[n_max + i] = vd;\n  }\n"
     "  __syncthreads();\n  stamp(14);\n  if (threadIdx.x == 0) {\n"
     "    unsigned sm;\n    asm volatile(\"mov.u32 %0, %%smid;\" : "
     "\"=r\"(sm));\n    tls[15] = sm;\n"
     "    unsigned long long* o = reinterpret_cast<unsigned long long*>("
     "\n        const_cast<double*>(Ub))\n"
     "        + (size_t)(blockIdx.y * gridDim.x + blockIdx.x) * 16;\n"
     "    for (int i = 0; i < 16; ++i) o[i] = tls[i];\n  }\n}\n"),
]

# one round's steps (this design), in SM clock cycles read by thread 0,
# a summing thread: chunk 3 landed (slot 7), its segment sums and the
# barrier after them (8), its knot sums (12), the summing threads' own
# copies of a later chunk (13 to 9: gathered chunks only; the bulk copies
# are the issuing warp's), chunk 4 waited for (10) and the barrier after
# (11); written as the timeline's
_STEPS = [
    ("  extern __shared__ __align__(16) double tsm[];\n",
     "  extern __shared__ __align__(16) double tsm[];\n"
     + _STAMP.replace("%%globaltimer", "%%clock64")),
    ("    __syncthreads();                        // (everyone's)\n",
     "    __syncthreads();                        // (everyone's)\n"
     "    if (c == 3) stamp(7);\n    if (c == 4) stamp(11);\n"),
    ("    __syncthreads();\n\n    // 2. a thread a (knot, row)",
     "    __syncthreads();\n    if (c == 3) stamp(8);\n\n"
     "    // 2. a thread a (knot, row)"),
    ("      db[r * ld + i] += td;\n    }\n  }\n",
     "      db[r * ld + i] += td;\n    }\n    if (c == 3) stamp(12);\n"
     "  }\n"),
    ("      gather(c + kStages - 1);\n",
     "      if (c == 4) stamp(13);\n      gather(c + kStages - 1);\n"
     "      if (c == 4) stamp(9);\n"),
    ("      bar_wait(bars + c % kStages, (c / kStages) & 1);  // and bulk\n",
     "      bar_wait(bars + c % kStages, (c / kStages) & 1);  // and bulk\n"
     "      if (c == 4) stamp(10);\n"),
    _TIMELINE[-1],
]


def _steps(res, blocks):
    """Medians and maxima over the blocks (cycles) of a ``steps``
    launch's stamps: chunk 3's segment sums, its knot sums, the summing
    threads' own copies, the wait for chunk 4, the barrier after it."""
    import numpy as np
    import torch
    t = res.reshape(-1).view(torch.int64)[:blocks * 16]
    t = t.reshape(blocks, 16).cpu().numpy()
    ok = np.all(t[:, 7:14] > 0, axis=1)
    t = t[ok].astype(np.float64)
    out = dict(blocks=int(ok.sum()))
    for name, (a, b) in {"segments": (7, 8), "knots": (8, 12),
                         "to_gather": (12, 13), "gather": (13, 9),
                         "wait": (9, 10), "barrier": (10, 11)}.items():
        d = t[:, b] - t[:, a]
        out[name] = (float(np.median(d)), float(d.max())) if d.size else None
    return out


# each variant: its patches on the parent's source, then on this design's
# (the first set whose targets are all in the source applies)
VARIANTS = {
    "full": ([],),
    "no_scan": ([_NO_SCAN, (_LAST, "    const bool last = live;\n")],),
    "live_rows": ([(_SCAN_ROWS, _SCAN_ROWS.replace(
        "      for (int q = 0; q < kRowsWarp; ++q) {\n",
        "      for (int q = 0; q < kRowsWarp; ++q) {\n"
        "        if (wid + q * kWarps >= rows) break;\n"))],),
    "no_smem_adds": ([_NO_ADDS],),
    "no_segments": ([_NO_SEGS],),
    "no_combine": ([_NO_CMB],),
    "no_solve": ([_PARENT_SOLVE], [_SOLVE]),
    "loads_only": ([_NO_SCAN, _NO_ADDS, _PARENT_SOLVE],
                   [_NO_SEGS, _NO_CMB, _SOLVE]),
    "no_queries": ([(_QUERIES, "  for (int k0 = 0; k0 < 0; k0 += 32) {\n")],
                   [(_CHUNKS, "  for (int c = 0; c < 0; ++c) {\n")]),
    "stages_more": ([(_STAGES, "  return tr >= 8 ? 3 : 4;"),
                     ("constexpr int kSmemT = 76800;",
                      "constexpr int kSmemT = 115200;")],),
    "values_only": ([_NO_SEGS, _NO_CMB, _SOLVE,
                     ("      bytes += nq * 32;\n", ""),
                     ("      bulk_copy(sw + s * kChunk * 4, w4 + 4 * (size_t)"
                      "(a.w - 1), nq * 32,\n                bars + s);\n",
                      "")],),
    "timeline": (_TIMELINE,),
    "steps": (_STEPS,),
    "no_carveout": ([("cudaSharedmemCarveoutMaxShared",
                      "cudaSharedmemCarveoutDefault")],),
    "no_unroll": ([("#pragma unroll\n      for (int k = 0; k < kSegLen; ++k)",
                    "#pragma unroll 1\n      for (int k = 0; k < kSegLen; "
                    "++k)")],),
    "tile4": ([(_TILE, "  const int tr = fit_t_tile(R, G, n_max, nc) < 4 ? "
                      "fit_t_tile(R, G, n_max, nc) : 4;\n")],),
    "tile2": ([(_TILE, "  const int tr = fit_t_tile(R, G, n_max, nc) < 2 ? "
                      "fit_t_tile(R, G, n_max, nc) : 2;\n")],),
}
# variants that keep the kernel's arithmetic: equal to it bit for bit
EXACT = {"full", "live_rows", "stages_more", "no_carveout", "no_unroll",
         "tile4", "tile2"}


def _timeline(res, blocks):
    """Summary (us, medians and maxima over the blocks) of the stamps a
    ``timeline`` launch wrote: the blocks' start spread, the chunk-table
    read, each chunk's interval, the solve, the stores, the span."""
    import numpy as np
    t = res.reshape(-1).view(__import__("torch").int64)[:blocks * 16]
    t = t.reshape(blocks, 16).cpu().numpy().astype(np.float64)
    t0 = t[:, 0].min()
    st = (t[:, :15] - t0) / 1e3
    st[t[:, :15] == 0] = np.nan
    out = dict(blocks=blocks, span=float(np.nanmax(st[:, 14])),
               start=(float(np.median(st[:, 0])), float(st[:, 0].max())),
               sms=int(len(set(t[:, 15].astype(int)))))
    steps = {"table": (0, 1), "chunk0": (1, 2), "solve": (12, 13),
             "stores": (13, 14)}
    for name, (a, b) in steps.items():
        d = st[:, b] - st[:, a]
        out[name] = (float(np.nanmedian(d)), float(np.nanmax(d)))
    last = np.array([np.nanmax(np.where(np.isnan(r[2:12]), -1, r[2:12]))
                     for r in st])
    n = np.array([np.sum(~np.isnan(r[2:12])) for r in st])
    per = [(r[2 + k] - r[1 + k]) for r in st for k in range(1, 10)
           if not np.isnan(r[2 + k])]
    out["chunk"] = (float(np.median(per)) if per else None,
                    float(np.max(per)) if per else None, int(n.max()))
    d = st[:, 12] - last
    out["after_chunks"] = (float(np.nanmedian(d)), float(np.nanmax(d)))
    return out


# appended to this design's sources: the launch a call gets (rows a
# tile, stages, shared memory) and the blocks an SM then holds
_PROBE = """
template <int S>
int k7_occupancy(size_t smem) {
  auto k = fitted_rows_t_kernel<S>;
  cudaFuncSetAttribute(k, cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  int nb = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, k, kThreads, smem);
  return nb;
}

extern "C" int k7_probe(int R, int G, int n_max, int nc, int* out) {
  const int tr = fit_t_tile(R, G, n_max, nc), st = fit_t_stages(tr);
  const size_t smem = fit_t_smem(tr, st, n_max, nc);
  out[0] = tr;
  out[1] = st;
  out[2] = (int)smem;
  out[3] = st == 2 ? k7_occupancy<2>(smem)
           : st == 3 ? k7_occupancy<3>(smem) : k7_occupancy<4>(smem);
  return (int)cudaGetLastError();
}
"""


def _build(name, text, nvcc, flags):
    """Start nvcc on a patched copy; returns (process, .so path)."""
    build = HERE / "adrates_torch/_build"
    build.mkdir(parents=True, exist_ok=True)
    src = build / f"k7_phases_{name}.cu"
    src.write_text(text)
    so = build / f"k7_phases_{name}.so"
    proc = subprocess.Popen([nvcc, *flags, "-Xptxas", "-v", "-shared", "-o",
                             str(so), str(src)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, so


def _capture(cs, dev) -> dict:
    """K7's largest calls on the spline cell: {label: (shape, members)}."""
    import numpy as np

    from adrates_torch.examples import flagship_v5 as cfg
    from adrates_torch.parallel import make_per_trade_gamma_fn
    from adrates_torch.parallel.multibook import warmup_multibook
    model = cfg.build_model(schemes=cfg.SPLINE_SCHEMES)
    with warnings.catch_warnings():        # CHF has no trades
        warnings.simplefilter("ignore", UserWarning)
        mb, shocks = cfg.build_book(model, np.random.default_rng(cfg.SEED))
    q0 = mb.basket.quotes0
    fn = warmup_multibook(mb, shocks.shape[0], dev, staged=True)
    got = cs._capture_fitted(fn, q0, shocks, dev)
    g = make_per_trade_gamma_fn(mb, cs._select_trades(mb)[0], dev)
    got.update(cs._watch_fitted([("gamma_256", lambda: g(q0))],
                                [("gamma_256", "fitted_rows_t")]))
    out = {}
    for key in CALLS:
        shape, tab = got[key]
        h = tab.host
        nw = tab.nw.tolist()
        out[key[0]] = (shape, [
            (h["x"][k, :h["ns"][k]].copy(), h["q"][k, :nw[k]].copy(),
             h["idx"][k, :nw[k]].copy(), int(h["kinds"][k]))
            for k in range(tab.G)])
    return out


class _Recorder:
    """Stands in for the kernels' library: keeps the arguments of each
    entry point's last call and returns 0 (no launch)."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        def record(*args):
            self.calls[name] = args
            return 0
        return record


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?", default=str(HERE))
    ap.add_argument("--inputs", default=str(HERE / ".chip_scratch"
                                            / "k7_inputs.pt"))
    ap.add_argument("--variants", nargs="*", choices=sorted(VARIANTS))
    args = ap.parse_args(argv[1:])
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("k7_phases: no CUDA device visible", file=sys.stderr)
        return 2
    import adrates_torch
    if root not in Path(adrates_torch.__file__).resolve().parents:
        raise AssertionError(f"imported {adrates_torch.__file__}, not from "
                             f"{root}")
    from adrates_torch.ops import kernels
    card = cs._card_line()
    dev = torch.device("cuda", 0)

    base = (root / "adrates_torch/csrc/fitted_rows.cu").read_text()
    procs, skipped = {}, []
    for name in args.variants or VARIANTS:
        patches = next((ps for ps in VARIANTS[name]
                        if all(old in base for old, _ in ps)), None)
        if patches is None:
            skipped.append(name)
            continue
        text = base
        for old, new in patches:
            text = text.replace(old, new)
        if "fit_t_tile" in text:
            text += _PROBE
        procs[name] = _build(name, text, kernels._nvcc(),
                             kernels._NVCC_FLAGS)
    if skipped:
        print(f"k7_phases: variants that do not apply to {root.name}'s "
              f"source: {skipped}", flush=True)
    libs, usage = {}, {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        usage[name] = [ln.strip() for ln in log.splitlines()
                       if "fitted_rows_t" in ln or "Used" in ln
                       or "spill" in ln]
        lib = ctypes.CDLL(str(so))
        fn = getattr(lib, ENTRY)
        fn.argtypes = kernels._SIGNATURES[ENTRY]
        fn.restype = ctypes.c_int
        libs[name] = lib
        print(f"{name}: {usage[name]}", flush=True)

    path = Path(args.inputs)
    if path.exists():
        inputs = torch.load(path, weights_only=False)
    else:
        inputs = _capture(cs, dev)
        path.parent.mkdir(parents=True, exist_ok=True)
        torch.save(inputs, path)
        print(f"k7_phases: K7 calls captured into {path}", flush=True)

    out = dict(root=str(root), card=card, registers=usage,
               skipped=skipped, runs=[], calls={})
    for label, (shape, members) in inputs.items():
        tab = kernels.fitted_tables(members, dev)
        Ub = torch.as_tensor(np.random.default_rng(16).standard_normal(
            shape), device=dev)
        R, G, W = shape
        ref = kernels.fitted_rows_t_plain(Ub, tab)
        scale = float(ref.abs().max())
        # the yardstick: one bmm by the members' dense operators, built on
        # the unit basis by the twin of K6
        kn = tab.K * tab.n_max
        eye = torch.eye(kn, dtype=torch.float64, device=dev).reshape(
            kn, 1, tab.K, tab.n_max).expand(kn, G, tab.K, tab.n_max)
        M = kernels.fitted_rows_plain(eye.contiguous(), tab).permute(
            1, 2, 0).contiguous()
        a = Ub.permute(1, 0, 2).contiguous()
        lib_err = float((torch.bmm(a, M) - ref.reshape(R, G, kn).permute(
            1, 0, 2)).abs().max()) / scale
        lib = cs._device_stats(lambda: torch.bmm(a, M))
        out["calls"][label] = dict(
            shape=list(shape), knots=tab.nk.tolist(), kinds=tab.kind.tolist(),
            queries=tab.nw.tolist(), bmm_ms=cs._cuda_ms(lambda: torch.bmm(a,
                                                                       M)),
            bmm_device_ms=lib and lib["median"], bmm_err=lib_err)
        del M, a, eye
        saved = kernels._lib
        rec = _Recorder()
        kernels._lib = rec
        X = torch.as_tensor(np.random.default_rng(17).standard_normal(
            (R, G, tab.K, tab.n_max)), device=dev)
        try:
            res = kernels.fitted_rows_t(Ub, tab)   # allocated, not launched
            u6 = kernels.fitted_rows(X, tab)
        finally:
            kernels._lib = saved
        argv_c = rec.calls[ENTRY]
        if "full" in libs:                 # K6 at the transposed shape
            lib6 = libs["full"]
            fn6 = getattr(lib6, "fitted_rows_f64")
            fn6.argtypes = kernels._SIGNATURES["fitted_rows_f64"]
            fn6.restype = ctypes.c_int

            def launch6():
                kernels._check(fn6(*rec.calls["fitted_rows_f64"]), "K6")

            launch6()
            torch.cuda.synchronize()
            d6 = cs._device_stats(launch6)
            out["calls"][label].update(
                k6_digest=hashlib.sha256(u6.cpu().numpy().tobytes())
                .hexdigest()[:16], k6_device_ms=d6 and d6["median"])
            print(f"K6 {label} X {[R, G, tab.K, tab.n_max]}: output digest "
                  f"{out['calls'][label]['k6_digest']}, device "
                  f"{cs._fmt_ms(out['calls'][label]['k6_device_ms'])}; card "
                  f"{card}", flush=True)
            del X, u6
        first = None
        ub0 = Ub.clone()
        for name, lib in libs.items():
            Ub.copy_(ub0)                  # a timeline writes over it
            if hasattr(lib, "k7_probe"):
                got = (ctypes.c_int * 4)()
                lib.k7_probe(R, G, tab.n_max, tab.nc, got)
                print(f"K7 {label} {name}: tiles of {got[0]} rows, {got[1]} "
                      f"stages, {got[2]} B of shared memory, {got[3]} "
                      f"blocks an SM", flush=True)
            def launch(lib=lib, name=name):
                kernels._check(getattr(lib, ENTRY)(*argv_c),
                               f"{name} {ENTRY}")
            res.fill_(float("nan"))
            launch()
            torch.cuda.synchronize()
            err = float((res - ref).abs().max()) / scale
            if first is None and name in EXACT:
                first = res.clone()
            exact = first is not None and bool(torch.equal(res, first))
            if name in EXACT and not (exact and err <= 1e-12):
                raise AssertionError(f"{name} {label}: err {err:.3e}, "
                                     f"equal to the kernel {exact}")
            for _ in range(3):
                launch()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(30):
                launch()
            e1.record()
            e1.synchronize()
            ms = e0.elapsed_time(e1) / 30
            dv = cs._device_stats(launch)
            r = dict(variant=name, call=label, ms=ms,
                     device_ms=dv and dv["median"], err=err, exact=exact)
            if name == "timeline":
                got = (ctypes.c_int * 4)()
                lib.k7_probe(R, G, tab.n_max, tab.nc, got)
                Ub.copy_(ub0)
                launch()
                torch.cuda.synchronize()
                r["timeline"] = _timeline(Ub, -(-R // got[0]) * G)
                print(f"K7 {label} timeline (us, median and max over "
                      f"blocks): {r['timeline']}", flush=True)
            if name == "steps":
                got = (ctypes.c_int * 4)()
                lib.k7_probe(R, G, tab.n_max, tab.nc, got)
                Ub.copy_(ub0)
                launch()
                torch.cuda.synchronize()
                r["steps"] = _steps(Ub, -(-R // got[0]) * G)
                print(f"K7 {label} steps (cycles, median and max over "
                      f"blocks): {r['steps']}", flush=True)
            out["runs"].append(r)
            print(f"K7 {label} {list(shape)} {name}: {ms:.4f} ms a launch "
                  f"back to back, device {cs._fmt_ms(r['device_ms'])}; err "
                  f"{err:.2e}; equal to the kernel {exact}; card {card}",
                  flush=True)
        c = out["calls"][label]
        print(f"K7 {label} yardstick torch.bmm {c['bmm_ms']:.4f} ms (device "
              f"{cs._fmt_ms(c['bmm_device_ms'])}; err {lib_err:.2e}); knots "
              f"{c['knots']}, kinds {c['kinds']}, queries {c['queries']}",
              flush=True)
        del Ub, ub0, ref, res, first, tab
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
