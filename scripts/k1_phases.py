#!/usr/bin/env python3
"""Where K1's trade-major time goes on the card: the kernel built with
parts cut out or changed, at flagship_v5's per-trade ladders.

    python3 scripts/k1_phases.py [--variants NAME ...]

Builds flagship_v5 (``adrates_torch/examples/flagship_v5.py``) and its
f64 and f32 ladder inputs (Jv [n_grid + T, N] and K1's tables, as
``make_per_trade_delta_fn(...).prep`` gives them), then compiles
variants of ``adrates_torch/csrc/pvs_sweep.cu`` made by text patches
into scratch libraries under ``adrates_torch/_build/``: the kernel as it
is; without the slot sums (the ring and the windows only); without the
ring's copies (sums over whatever the stages hold); with neither;
without the output stores (kept behind a test no sum passes, so the sums
stay); with the output and the slot tables written and read with
evict-first hints (``__stcs`` / ``__ldcs``); with the ring's copies
asking the L2 to keep Jv (``evict_last``); with the slot loop unrolled
by 4; without the barrier a chunk (a timing probe: a stage may be read
before it lands); summing only each warp's longer or only its shorter
trade; summing a warp's two trades in one loop of lockstep passes; with
three ring stages (one block an SM in f64), stages of 16 rows, three
stages of 16 rows; and with three blocks an SM in f32 (``--variants``:
a subset). Each variant runs in both dtypes where its ring fits the
shared memory, and is timed by CUDA events around 30 back-to-back
launches of the bare C entry point (no wrapper),
divided by 30, after checking its output against the wrapper's (equal
bit for bit where the variant keeps the arithmetic). Prints each
variant's registers and spills (``nvcc -Xptxas -v``), one line a
measurement with the card's name and power limit, and a JSON line last.
Needs one CUDA card and nvcc.
"""

import argparse
import ctypes
import importlib.util
import json
import re
import subprocess
import sys
import warnings
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
SRC = HERE / "adrates_torch/csrc/pvs_sweep.cu"

_SUM_LOOP = "      for (int r = 0; r < cnt[j]; ++r) {\n"
_COPY = "        if (q < nq) cp_async16(dst + kVec * q, src + kVec * q);\n"
_NO_SUMS = (_SUM_LOOP, "      for (int r = 0; r < 0; ++r) {\n")
_NO_COPIES = (_COPY, "        if (q < 0) cp_async16(dst, src);\n")
_SUM_BLOCK = """#pragma unroll
    for (int j = 0; j < kTPW; ++j) {
      for (int r = 0; r < cnt[j]; ++r) {
        const int lr = __shfl_sync(0xffffffffu, wr[j], r);
        const T w = __shfl_sync(0xffffffffu, ww[j], r);
        const T* row = st + (lr - lo) * pitch;
"""
# both trades of a warp in one loop of max(cnt) passes, a trade's loads
# and FMAs skipped in a pass where it has no slot
_LOCKSTEP = """    const int passes = max(cnt[0], cnt[1]);
    for (int r = 0; r < passes; ++r) {
#pragma unroll
      for (int j = 0; j < kTPW; ++j) {
        const int lr = __shfl_sync(0xffffffffu, wr[j], r);
        const T w = __shfl_sync(0xffffffffu, ww[j], r);
        if (r >= cnt[j]) continue;
        const T* row = st + (lr - lo) * pitch;
"""
_STAGES = "constexpr int kTMStages = 2;"
_ROWS = "constexpr int kTMRows = 32;"
_STORE_GUARD = "    if (t >= B) continue;\n    T* orow"
_CP = ('  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n" ::"r"(s),'
       '\n               "l"(gmem));\n')
VARIANTS = {
    "full": [],
    "no_sums": [_NO_SUMS],
    "no_copies": [_NO_COPIES],
    "no_sums_no_copies": [_NO_SUMS, _NO_COPIES],
    "no_stores": [(_STORE_GUARD, "    if (t >= B || acc[j][0][0] != "
                                 "T(-7.25e-300)) continue;\n    T* orow")],
    "evict_first": [
        ("        store_piece<T>(orow + col, acc[j][k]);\n",
         "        store_piece_cs<T>(orow + col, acc[j][k]);\n"),
        ("          if (col + e < N) orow[col + e] = acc[j][k][e];\n",
         "          if (col + e < N) __stcs(orow + col + e, acc[j][k][e]);\n"),
        ("__ldg(slot_row + ", "__ldcs(slot_row + "),
        ("__ldg(slot_w + ", "__ldcs(slot_w + "),
        ("template <typename T>\n__global__ void __launch_bounds__(kThreads, "
         "2)\npvs_sweep_tm_kernel",
         "template <typename T>\n__device__ __forceinline__ void "
         "store_piece_cs(T* dst, const T* acc) {\n"
         "  if constexpr (sizeof(T) == 8) {\n"
         "    __stcs(reinterpret_cast<double2*>(dst), make_double2(acc[0], "
         "acc[1]));\n  } else {\n"
         "    __stcs(reinterpret_cast<float4*>(dst), make_float4(acc[0], "
         "acc[1], acc[2], acc[3]));\n  }\n}\n\n"
         "template <typename T>\n__global__ void __launch_bounds__(kThreads, "
         "2)\npvs_sweep_tm_kernel")],
    "evict_last": [(_CP,
                    '  unsigned long long pol;\n'
                    '  asm volatile("createpolicy.fractional.L2::evict_last'
                    '.b64 %0, 1.0;\\n" : "=l"(pol));\n'
                    '  asm volatile("cp.async.cg.shared.global.L2::cache_hint'
                    ' [%0], [%1], 16, %2;\\n" ::"r"(s), "l"(gmem), "l"(pol));'
                    '\n')],
    "unroll4": [(_SUM_LOOP, "#pragma unroll 4\n" + _SUM_LOOP)],
    "no_barrier": [("    __syncthreads();                    // for every "
                    "thread; c-1 consumed\n    load_chunk(c + kTMStages",
                    "    load_chunk(c + kTMStages")],
    "longer_only": [(_SUM_LOOP, "      for (int r = 0; r < (j ? 0 : "
                                "cnt[j]); ++r) {\n")],
    "shorter_only": [(_SUM_LOOP, "      for (int r = 0; r < (j ? cnt[j] : "
                                 "0); ++r) {\n")],
    "lockstep": [(_SUM_BLOCK, _LOCKSTEP)],
    "stages3": [(_STAGES, "constexpr int kTMStages = 3;")],
    "rows16": [(_ROWS, "constexpr int kTMRows = 16;")],
    "stages3_rows16": [(_STAGES, "constexpr int kTMStages = 3;"),
                       (_ROWS, "constexpr int kTMRows = 16;")],
    "f32_three_blocks": [("template <typename T>\n__global__ void "
                          "__launch_bounds__(kThreads, 2)\n"
                          "pvs_sweep_tm_kernel",
                          "template <typename T>\n__global__ void "
                          "__launch_bounds__(kThreads, sizeof(T) == 4 ? 3 "
                          ": 2)\npvs_sweep_tm_kernel")],
}
# variants whose output is the kernel's own, bit for bit
EXACT = {"full", "evict_first", "evict_last", "unroll4", "lockstep",
         "stages3", "rows16", "stages3_rows16", "f32_three_blocks"}
SMEM_MAX = 227 * 1024


def _ring(text: str):
    """(stages, rows a stage) of a variant's source."""
    return tuple(int(re.search(rf"constexpr int {k} = (\d+);", text)[1])
                 for k in ("kTMStages", "kTMRows"))


def _build(name, text, nvcc, flags):
    """Start nvcc on a patched copy; returns (process, .so path)."""
    build = HERE / "adrates_torch/_build"
    build.mkdir(parents=True, exist_ok=True)
    src = build / f"k1_phases_{name}.cu"
    src.write_text(text)
    so = build / f"k1_phases_{name}.so"
    proc = subprocess.Popen([nvcc, *flags, "-Xptxas", "-v", "-shared", "-o",
                             str(so), str(src)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, so


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", nargs="*", choices=sorted(VARIANTS))
    args = ap.parse_args(argv[1:])
    sys.path.insert(0, str(HERE))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("k1_phases: no CUDA device visible", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from adrates_torch.examples import flagship_v5 as cfg
    from adrates_torch.ops import kernels
    from adrates_torch.parallel import make_per_trade_delta_fn
    card = cs._card_line()
    base = SRC.read_text()
    procs = {}
    for name in args.variants or VARIANTS:
        patches = VARIANTS[name]
        text = base
        for old, new in patches:
            if old not in text:
                raise AssertionError(f"{name}: patch target not found: "
                                     f"{old!r}")
            text = text.replace(old, new)
        procs[name] = (_build(name, text, kernels._nvcc(),
                              kernels._NVCC_FLAGS), _ring(text))
    libs, usage = {}, {}
    for name, ((proc, so), ring) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        usage[name] = [ln.strip() for ln in log.splitlines()
                       if "Used" in ln or "spill" in ln]
        lib = ctypes.CDLL(str(so))
        for entry in ("pvs_sweep_tm_f64", "pvs_sweep_tm_f32"):
            fn = getattr(lib, entry)
            fn.argtypes = kernels._SIGNATURES[entry]
            fn.restype = ctypes.c_int
        libs[name] = (lib, ring)
        print(f"{name}: {usage[name]}", flush=True)

    dev = torch.device("cuda", 0)
    model = cfg.build_model()
    with warnings.catch_warnings():        # CHF has no trades
        warnings.simplefilter("ignore", UserWarning)
        mb, _ = cfg.build_book(model, np.random.default_rng(cfg.SEED))
    out = dict(card=card, registers=usage, runs=[])
    for dname, dtype in (("f64", None), ("f32", torch.float32)):
        fn = make_per_trade_delta_fn(mb, dev, dtype=dtype)
        Jv, tab = fn.prep(mb.basket.quotes0)[2], fn.sweep
        M, N = Jv.shape
        B = tab.n_trades
        plan = kernels.sweep_plan(N, Jv.dtype)
        ref = kernels.pvs_sweep(Jv, tab, trade_major=True)
        size = Jv.element_size()
        entry = f"pvs_sweep_tm_{dname}"
        for name, (lib, (stages, rows)) in libs.items():
            smem = stages * rows * plan.pitch * size
            if smem > SMEM_MAX:
                continue
            res = torch.full((B, N), float("nan"), dtype=Jv.dtype,
                             device=dev)
            stream = kernels._stream(dev)

            def launch():
                kernels._check(getattr(lib, entry)(
                    Jv.data_ptr(), Jv.stride(0), N, plan.pitch,
                    tab.tptr.data_ptr(), tab.slot_row.data_ptr(),
                    tab.slot_w.data_ptr(), tab.bptr.data_ptr(),
                    tab.brow.data_ptr(), B, res.data_ptr(), stream),
                    f"{name} {entry}")

            launch()
            torch.cuda.synchronize()
            exact = bool(torch.equal(res, ref))
            if name in EXACT and not exact:
                raise AssertionError(f"{name} {dname}: differs from the "
                                     f"wrapper's")
            for _ in range(3):
                launch()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(30):
                launch()
            b.record()
            b.synchronize()
            ms = a.elapsed_time(b) / 30
            rec = dict(variant=name, dtype=dname, rows=rows, stages=stages,
                       smem=smem, ms=ms, exact=exact)
            out["runs"].append(rec)
            print(f"K1 trade-major {dname} {name} ({stages} stages of "
                  f"{rows} rows, {smem} B): {ms:.4f} ms a launch; equal to "
                  f"the kernel's {exact}; card {card}", flush=True)
            del res
        del Jv, ref
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
