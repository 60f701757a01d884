#!/usr/bin/env python3
"""Where K6's time goes on the card: ``fitted_eval`` and its tangent mode
built with parts cut out or its launch changed, at the spline cell's
shapes.

    python3 scripts/k6_phases.py [--variants NAME ...]

This checkout's ``adrates_torch/csrc/fitted_rows.cu`` is compiled into
scratch libraries under ``adrates_torch/_build/``, once as it is
(``full``) and once for each variant made by text patches:
``no_stores`` (the values and tangents computed, their stores behind a
test no value passes: the block's prologue, slopes and Hermite rows
without the writes), ``no_slopes`` (PCHIP's slopes and the spline's
solve skipped: the slope rows hold whatever shared memory held),
``no_qtiles`` (one-row tiles
not cut into query tiles where they leave SMs without a block), ``lb3`` / ``lb4`` (``__launch_bounds__`` asking for 3 or 4 blocks of
256 threads an SM, so at most 80 or 64 registers), ``blocks1`` (the
tangent mode's directions split only until every SM has a block, not on
to two blocks an SM where a block keeps 2^15 outputs), ``blocks4``
(every tile rule asks for 4 blocks an SM).

The calls, on seeded inputs (the card tests' generator in
``tests/test_torch_kernels_cuda.py``: knots 0.25-2 apart, sorted queries
to two intervals past the last knot, DFs of a noisy upward zero curve):
region A's tangent call (the spline cell's five members of 43 and 73
knots, 2,225 queries, 50 rows x 32 directions), region C1's (one PCHIP
zero-rate member of 73 knots, 744 queries in two sorted runs, 50 x 32)
and the 256 gammas' (4,337 queries, one row x 1,024 directions), and
each one's primal call (50, 50 and 1 rows). Each variant is launched through
its own library's C entry with this checkout's tables, its output held
to the plain version (1e-12 x max|ref|) where it keeps the arithmetic,
and timed by CUDA events around 30 back-to-back launches (``ms``) and by
its kernels' device time in a torch.profiler trace (``device_ms``,
chip_smoke's ``_device_stats``). Prints each variant's registers and
spill bytes (``nvcc -Xptxas -v``), one line a measurement with the
card's name and power limit, and a JSON line last. Needs one CUDA card
and nvcc.
"""

import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
SRC = HERE / "adrates_torch" / "csrc" / "fitted_rows.cu"

_STORES = ("            Y[((pr * D + k0 + k) * G + g) * W_max + w] = "
           "mul(v, mul(f, du));")
_EVAL = ("          Y[((size_t)(p0 + p) * G + g) * W_max + w] =\n"
         "              kMode == kLinear ? u : exp(mul(f, u));")
VARIANTS = {
    "full": [],
    "no_stores": [
        (_STORES, "            const double o = mul(v, mul(f, du));\n"
                  "            if (o == 1.2345e300) "
                  "Y[((pr * D + k0 + k) * G + g) * W_max + w] = o;"),
        (_EVAL, "          const double o = kMode == kLinear ? u : "
                "exp(mul(f, u));\n"
                "          if (o == 1.2345e300) "
                "Y[((size_t)(p0 + p) * G + g) * W_max + w] = o;")],
    "no_slopes": [("  if (kd == 0 && kMode != kLinear) {",
                   "  if (false) {"),
                  ("  } else if (kd != 0) {", "  } else if (false) {")],
    "no_qtiles": [("  if (b < sms) {", "  if (false) {")],
    "lb3": [("__launch_bounds__(kThreads, 2)\n    k6_kernel",
             "__launch_bounds__(kThreads, 3)\n    k6_kernel")],
    "lb4": [("__launch_bounds__(kThreads, 2)\n    k6_kernel",
             "__launch_bounds__(kThreads, 4)\n    k6_kernel")],
    "blocks1": [("blocks(1, t.td) < 2 * sms", "blocks(1, t.td) < 0")],
    "blocks4": [("  const long sms = sm_count();",
                 "  const long sms = 4L * sm_count();")],
}
# variants that keep the arithmetic and the stores: held to the plain
# version and bit for bit to ``full``
EXACT = ("full", "lb3", "lb4", "blocks1", "blocks4", "no_qtiles")


def _load(name):
    spec = importlib.util.spec_from_file_location(name, HERE / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _build(name, patches, nvcc, kernels):
    text = SRC.read_text()
    for old, new in patches:
        if old not in text:
            raise AssertionError(f"variant {name}: patch target missing")
        text = text.replace(old, new)
    out = HERE / "adrates_torch" / "_build" / f"k6_{name}"
    out.mkdir(parents=True, exist_ok=True)
    src = out / "fitted_rows.cu"
    src.write_text(text)
    res = subprocess.run([nvcc, *kernels._NVCC_FLAGS, "-Xptxas", "-v",
                          "-shared", "-o", str(out / "lib.so"), str(src)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc {name}: {res.stderr}")
    regs = [ln.split("Used ")[1].split(" registers")[0]
            for ln in res.stderr.splitlines() if "Used " in ln]
    spills = sorted({ln.split(": ", 1)[-1].strip()
                     for ln in res.stderr.splitlines() if "spill" in ln})
    lib = ctypes.CDLL(str(out / "lib.so"))
    for entry in ("fitted_eval_f64", "fitted_eval_jvp_f64"):
        fn = getattr(lib, entry)
        fn.argtypes = kernels._SIGNATURES[entry]
        fn.restype = ctypes.c_int
    return lib, regs, spills


def main(argv) -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("k6_phases: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(HERE / "tests"))
    cs = _load("chip_smoke")
    tk = _load("tests/test_torch_kernels_cuda")
    from adrates_torch.ops import fitted_rows as tfr
    from adrates_torch.ops import kernels
    names = argv[argv.index("--variants") + 1:] if "--variants" in argv \
        else list(VARIANTS)
    dev = torch.device("cuda", 0)
    card = cs._card_line()
    nvcc = kernels._nvcc()

    cells = tk._SPLINE_CELL
    rng = np.random.default_rng(20)
    calls = {"A": (tk._eval_plans(rng, *cells, (2225,) * 5), 50, 32),
             "C1": (tk._eval_plans(rng, ("PCHIP_ZERO_RATES",), (73,),
                                   (744,), 2), 50, 32),
             "gamma_256": (tk._eval_plans(rng, *cells, (4337,) * 5), 1,
                           1024)}
    inputs = {}
    for label, (plans, R, D) in calls.items():
        plan = tfr.fitted_plan(plans, dev)
        tab = plan.tables
        g = np.random.default_rng(21)
        x = tab.host["x"]
        L = tab.n_max + 2
        d = np.full((R, tab.G, L), 0.5)
        d[..., :tab.n_max] = np.exp(-(0.02 + 0.01 * np.sqrt(np.abs(x))
                                      + g.uniform(-2e-3, 2e-3, (R,) + x.shape))
                                    * x)
        dfs = torch.tensor(d, device=dev)
        ddfs = torch.tensor(g.normal(size=(R, D, tab.G, L)), device=dev)
        out = tfr.fitted_eval_plain(plan, dfs)
        ref = tfr.fitted_eval_jvp_plain(plan, dfs, ddfs, out)
        inputs[label] = (plan, dfs, ddfs, out, ref)

    res, full = {}, {}
    for name in names:
        lib, regs, spills = _build(name, VARIANTS[name], nvcc, kernels)
        print(f"k6_phases {name}: registers (tangent, eval, linear) "
              f"{regs[-3:]}; ptxas {spills}", flush=True)
        for label, (plan, dfs, ddfs, out, ref) in inputs.items():
            tab = plan.tables
            R, D, G, L = ddfs.shape
            ptrs = kernels._eval_tables(plan, dev)
            stream = kernels._stream(dev)
            for mode in ("tangent", "eval"):
                shape = (R, D, G, tab.W_max) if mode == "tangent" \
                    else (R, G, tab.W_max)
                y = torch.empty(shape, dtype=torch.float64, device=dev)
                if mode == "tangent":
                    def launch(lib=lib, y=y, ptrs=ptrs, R=R, D=D, G=G, L=L,
                               dfs=dfs, ddfs=ddfs, out=out, tab=tab):
                        kernels._check(lib.fitted_eval_jvp_f64(
                            dfs.data_ptr(), ddfs.data_ptr(), out.data_ptr(),
                            R, D, G, L, tab.n_max, tab.W_max, *ptrs,
                            y.data_ptr(), stream), "fitted_eval_jvp_f64")
                    want = ref
                else:
                    def launch(lib=lib, y=y, ptrs=ptrs, R=R, G=G, L=L,
                               dfs=dfs, tab=tab):
                        kernels._check(lib.fitted_eval_f64(
                            dfs.data_ptr(), R, G, L, tab.n_max, tab.W_max,
                            *ptrs, y.data_ptr(), stream), "fitted_eval_f64")
                    want = out
                launch()
                torch.cuda.synchronize()
                key = f"{label} {mode}"
                rec = dict(variant=name, call=key, shape=list(shape),
                           registers=regs[-3:])
                if name in EXACT:
                    rec["err"] = float((y - want).abs().max()
                                       / want.abs().max())
                    if rec["err"] > 1e-12:
                        raise AssertionError(f"{name} {key}: {rec['err']}")
                    if name == "full":
                        full[key] = y.clone()
                    elif key in full:
                        rec["bit_for_bit_full"] = bool(torch.equal(
                            y, full[key]))
                rec["ms"] = cs._cuda_ms(launch)
                dv = cs._device_stats(launch)
                rec["device_ms"] = dv and dv["median"]
                info = kernels.fitted_kernel_info(mode, R, G, tab.n_max,
                                                  tab.W_max, D)
                rec["full_tiles"] = {k: info[k] for k in (
                    "tile_rows", "tile_dirs", "tile_queries", "blocks",
                    "smem_bytes")}
                res.setdefault(name, []).append(rec)
                print(f"k6_phases {name} {key} {list(shape)}: device "
                      f"{cs._fmt_ms(rec['device_ms'])}, events "
                      f"{rec['ms']:.4f} ms"
                      + (f", err {rec['err']:.1e}" if "err" in rec else "")
                      + (f", = full bit for bit {rec['bit_for_bit_full']}"
                         if "bit_for_bit_full" in rec else "")
                      + f"; card {card}", flush=True)
                del y
    print(json.dumps({"card": card, "k6_phases": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
