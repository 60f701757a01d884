#!/usr/bin/env python3
"""Where K3's time goes on the card: the kernel built with phases cut out.

    python3 scripts/k3_phases.py

Measures the FP64 tensor-core rate of three mma.sync shapes (m8n8k4,
m16n8k4, m16n8k16), builds flagship_v5's per-trade K3 operands (the 256
selected trades of ``chip_smoke.py`` and every trade's own block), then
compiles variants of ``adrates_torch/csrc/pertrade_quad_form.cu`` made by
text patches into scratch libraries under ``adrates_torch/_build/``: the
kernel as it is, without the epilogue's stores, without the tensor-core
products, without the Jt gathers, with only the set-up and the stores,
and with a %globaltimer timeline (each block's set-up, segments and
stores, and its segments' issue, wait, w X / Y and product phases
summed). Each variant is timed on both paths by CUDA events around 30
back-to-back launches of the bare C entry point (no wrapper), divided by
30. Needs one CUDA card and nvcc. Prints a JSON line last.
"""

import ctypes
import importlib.util
import json
import subprocess
import sys
import warnings
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
SRC = HERE / "adrates_torch/csrc/pertrade_quad_form.cu"

VARIANTS = {
    "full": [],
    "no_stores": [("      if (row < 0 || col < 0) return;\n",
                   "      if (row < 0 || col < 0 || k > 0) return;\n")],
    "no_mma": [("      if (mine > 0) {\n        const int nv",
                "      if (false) {\n        const int nv")],
    "no_gathers": [("      for (int t = t0; t < min(kSeg, nv); t += tstep) {",
                    "      for (int t = kSeg; t < min(kSeg, nv); t += tstep) {")],
    "epilogue_only": [("  for (int c0 = 0; c0 < nseg; c0 += mc) {",
                       "  for (int c0 = 0; c0 < 0; c0 += mc) {")],
}
# the full kernel with each block's %globaltimer at its start, after its
# set-up (its rows and first slot chunk), after its segments and at its
# end, its SM, and the summed time of each phase of its segments (issuing
# the gathers, waiting for them, forming w X and Y, the products), of its
# later slot chunks' coefficient loads and their count, into a device
# array read back by tl_read
_NOW = "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"({}));\n"
_TL = 12
TIMELINE = [
    ("namespace {\n",
     f"__device__ unsigned long long g_tl[{_TL} * 16384];\nnamespace {{\n"),
    ("  const int grp = lane >> 2, q4 = lane & 3;\n",
     "  const int grp = lane >> 2, q4 = lane & 3;\n"
     "  unsigned long long tl[4] = {}, ts[6] = {}, ta, tb, tc, td, te;\n  "
     + _NOW.format("tl[0]")),
    ("  __syncthreads();                     // rows and the first chunk "
     "visible\n",
     "  __syncthreads();                     // rows and the first chunk "
     "visible\n  " + _NOW.format("tl[1]")),
    ("    if (c0 > 0) {\n      load_meta(c0, mn);\n      __syncthreads();\n",
     "    if (c0 > 0) {\n      " + _NOW.format("ta")
     + "      load_meta(c0, mn);\n      __syncthreads();\n      "
     + _NOW.format("tb") + "      ts[4] += 1;\n      ts[5] += tb - ta;\n"),
    ("      if (j + ns - 1 < mn) issue(j + ns - 1);\n"
     "      cp_async_commit();\n"
     "      cp_async_wait(ns - 1);           // segment j has landed\n"
     "      __syncthreads();\n",
     "      " + _NOW.format("ta")
     + "      if (j + ns - 1 < mn) issue(j + ns - 1);\n"
     "      cp_async_commit();\n      " + _NOW.format("tb")
     + "      cp_async_wait(ns - 1);           // segment j has landed\n"
     "      __syncthreads();\n      " + _NOW.format("tc")
     + "      ts[0] += tb - ta;\n      ts[1] += tc - tb;\n"),
    ("      __syncthreads();\n      if (mine > 0) {\n        const int nv",
     "      __syncthreads();\n      " + _NOW.format("td")
     + "      ts[2] += td - tc;\n"
     "      if (mine > 0) {\n        const int nv"),
    ("      __syncthreads();                 // stage j % ns and X, Y free\n",
     "      __syncthreads();                 // stage j % ns and X, Y free\n"
     "      " + _NOW.format("te") + "      ts[3] += te - td;\n"),
    ("  __syncthreads();                     // coefficients free for the "
     "buffers\n",
     "  __syncthreads();                     // coefficients free for the "
     "buffers\n  " + _NOW.format("tl[2]")),
    ("        advance(I2, J);\n      }\n    }\n  }\n}\n",
     "        advance(I2, J);\n      }\n    }\n  }\n  __syncthreads();\n"
     "  if (tid == 0) {\n    " + _NOW.format("tl[3]")
     + "    unsigned sm;\n    asm volatile(\"mov.u32 %0, %%smid;\" : "
     "\"=r\"(sm));\n"
     f"    unsigned long long* g = g_tl + {_TL} * blockIdx.x;\n"
     "    for (int i = 0; i < 4; ++i) g[i] = tl[i];\n"
     "    g[4] = sm;\n    for (int i = 0; i < 6; ++i) g[5 + i] = ts[i];\n"
     "  }\n}\n"),
    ("extern \"C\" int pertrade_quad_f64(",
     "extern \"C\" int tl_read(unsigned long long* host, int n) {\n"
     f"  return (int)cudaMemcpyFromSymbol(host, g_tl, 8 * {_TL} * n);\n}}\n\n"
     "extern \"C\" int pertrade_quad_f64("),
]
VARIANTS["timeline"] = TIMELINE

# the FP64 tensor-core rate per mma.sync shape: every warp of 132 x 4
# blocks of 256 threads runs `iters` rounds of 8 independent products
DMMA = r"""
#include <cuda_runtime.h>
template <int S>
__global__ void dmma_rate(double* out, int iters) {
  double d[8][4] = {};
  const double a = threadIdx.x * 1e-3, b = 1.0 + blockIdx.x * 1e-6;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      if (S == 0) {
        asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
                     "{%0,%1}, {%2}, {%3}, {%0,%1};\n"
                     : "+d"(d[t][0]), "+d"(d[t][1]) : "d"(a), "d"(b));
      } else if (S == 1) {
        asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
                     "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
                     : "+d"(d[t][0]), "+d"(d[t][1]), "+d"(d[t][2]),
                       "+d"(d[t][3]) : "d"(a), "d"(a), "d"(b));
      } else {
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
                     "{%0,%1,%2,%3}, {%4,%5,%6,%7,%8,%9,%10,%11}, "
                     "{%12,%13,%14,%15}, {%0,%1,%2,%3};\n"
                     : "+d"(d[t][0]), "+d"(d[t][1]), "+d"(d[t][2]),
                       "+d"(d[t][3])
                     : "d"(a), "d"(a), "d"(a), "d"(a), "d"(a), "d"(a),
                       "d"(a), "d"(a), "d"(b), "d"(b), "d"(b), "d"(b));
      }
    }
  }
  double s = 0.0;
  for (int t = 0; t < 8; ++t) s += d[t][0] + d[t][1] + d[t][2] + d[t][3];
  if (s == 12345.678) out[threadIdx.x] = s;
}
// TFLOP/s of shape S (0: m8n8k4, 1: m16n8k4, 2: m16n8k16)
extern "C" double dmma_tflops(int S, int iters) {
  double* out;
  cudaMalloc(&out, 4096);
  const int blocks = 132 * 4, threads = 256;
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  for (int rep = 0; rep < 2; ++rep) {
    cudaEventRecord(a);
    if (S == 0) dmma_rate<0><<<blocks, threads>>>(out, iters);
    else if (S == 1) dmma_rate<1><<<blocks, threads>>>(out, iters);
    else dmma_rate<2><<<blocks, threads>>>(out, iters);
    cudaEventRecord(b);
    cudaEventSynchronize(b);
  }
  float ms = 0.f;
  cudaEventElapsedTime(&ms, a, b);
  cudaFree(out);
  const double flops_per = S == 0 ? 512.0 : S == 1 ? 1024.0 : 4096.0;
  return (double)blocks * threads / 32 * iters * 8 * flops_per
         / (ms * 1e-3) / 1e12;
}
"""


def _build(name, text, nvcc, flags):
    out = HERE / "adrates_torch/_build" / f"k3_phase_{name}"
    out.parent.mkdir(parents=True, exist_ok=True)
    src = out.with_suffix(".cu")
    src.write_text(text)
    so = out.with_suffix(".so")
    return subprocess.Popen([nvcc, *flags, "-shared", "-o", str(so),
                             str(src)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True), so


def main() -> int:
    sys.path.insert(0, str(HERE))
    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("k3_phases: no CUDA device visible", file=sys.stderr)
        return 2
    from adrates_torch.examples import flagship_v5 as cfg
    from adrates_torch.ops import kernels
    from adrates_torch.parallel import (make_per_trade_gamma_blocks_fn,
                                        make_per_trade_gamma_fn)
    text = SRC.read_text()
    procs = {}
    for name, patches in VARIANTS.items():
        t = text
        for old, new in patches:
            if old not in t:
                raise AssertionError(f"{name}: patch target not found")
            t = t.replace(old, new)
        procs[name] = _build(name, t, kernels._nvcc(), kernels._NVCC_FLAGS)
    rate = _build("dmma_rate", DMMA, kernels._nvcc(), kernels._NVCC_FLAGS)
    libs = {}
    for name, (p, so) in procs.items():
        _, err = p.communicate()
        if p.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{err}")
        lib = ctypes.CDLL(str(so))
        lib.pertrade_quad_f64.argtypes = \
            kernels._SIGNATURES["pertrade_quad_f64"]
        libs[name] = lib
    res_rate = {}
    _, err = rate[0].communicate()
    if rate[0].returncode:
        res_rate["error"] = err[-2000:]
    else:
        lib = ctypes.CDLL(str(rate[1]))
        lib.dmma_tflops.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.dmma_tflops.restype = ctypes.c_double
        for s, shape in enumerate(("m8n8k4", "m16n8k4", "m16n8k16")):
            res_rate[shape] = lib.dmma_tflops(s, 2048)
    print("FP64 mma.sync TFLOP/s", res_rate, flush=True)

    dev = torch.device("cuda", 0)
    model = cfg.build_model()
    with warnings.catch_warnings():        # CHF has no trades
        warnings.simplefilter("ignore", UserWarning)
        mb, _ = cfg.build_book(model, np.random.default_rng(cfg.SEED))
    q0 = mb.basket.quotes0
    sel, _, _ = cs._select_trades(mb)
    res = dict(card=cs._card_line(), reps=30, dmma_tflops=res_rate,
               paths={})
    for path, fn in (("flagship_v5_gamma_256",
                      make_per_trade_gamma_fn(mb, sel, dev)),
                     ("flagship_v5_gamma_blocks",
                      make_per_trade_gamma_blocks_fn(mb, dev))):
        _, dfs, Jt, w = fn.prep(q0)
        t = fn.k3
        out = torch.empty(t.n_out, dtype=torch.float64, device=dev)
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        times = {}
        for name, lib in libs.items():
            def launch():
                err = lib.pertrade_quad_f64(
                    Jt.data_ptr(), Jt.shape[1], dfs.data_ptr(), w.data_ptr(),
                    t.order.data_ptr(), t.packs.data_ptr(),
                    t.packs.shape[0], t.rows_max, t.units.data_ptr(),
                    t.prows.data_ptr(), t.s_idx.data_ptr(),
                    t.e_idx.data_ptr(), t.p_idx.data_ptr(), out.data_ptr(),
                    stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            launch()
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(res["reps"]):
                launch()
            b.record()
            b.synchronize()
            times[name] = a.elapsed_time(b) / res["reps"]
        n = int(t.packs.shape[0])
        tl = np.zeros(_TL * n, dtype=np.uint64)
        lib = libs["timeline"]
        lib.tl_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
        if lib.tl_read(tl.ctypes.data, n):
            raise RuntimeError("tl_read failed")
        tl = tl.reshape(n, _TL).astype(np.int64)
        t0 = tl[:, 0].min()
        us = (tl[:, :4] - t0) / 1e3
        seg_ph = tl[:, 5:11] / np.array([1e3] * 4 + [1, 1e3])
        ph = dict(setup=us[:, 1] - us[:, 0], segments=us[:, 2] - us[:, 1],
                  stores=us[:, 3] - us[:, 2], pack=us[:, 3] - us[:, 0])
        timeline = {k: dict(median=float(np.median(v)), max=float(v.max()),
                            sum=float(v.sum())) for k, v in ph.items()}
        timeline["span_us"] = float(us[:, 3].max())
        timeline["last_start_us"] = float(us[:, 0].max())
        timeline["sms"] = int(np.unique(tl[:, 4]).size)
        timeline["busy_share"] = float(
            ph["pack"].sum() / us[:, 3].max() / timeline["sms"])
        # the slowest packs: (segments, staged rows, units, us in their
        # segment loop, us per segment)
        pk = t.packs.cpu().numpy().astype(np.int64)
        slow = np.argsort(-ph["segments"])[:6]
        timeline["slowest"] = [
            (int(pk[b, 2]), int(pk[b, 3]), int(pk[b, 1] - pk[b, 0]),
             round(float(ph["segments"][b]), 2),
             round(float(ph["segments"][b]) / max(int(pk[b, 2]), 1), 2))
            for b in slow]
        # summed over every pack, us: issue, wait, transform, products,
        # later coefficient chunks (a count), their loads
        timeline["segment_phases_us"] = dict(zip(
            ("issue", "wait", "transform", "mma", "chunks", "meta"),
            seg_ph.sum(axis=0).round(1).tolist()))
        res["paths"][path] = dict(packs=n, units=int(t.units.shape[0]),
                                  ms=times, timeline=timeline)
        print(path, "timeline", json.dumps(timeline), flush=True)
        print(path, {k: round(v * 1e3, 1) for k, v in times.items()},
              "us; card", res["card"], flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
