#!/usr/bin/env python3
"""K1's f64 and f32 instantiations (``pvs_sweep``, ``pvs_sweep_f32``) at
the flagship_v5 per-trade ladders' shape, on one CUDA card.

    python3 scripts/k1_f32_ab.py

Builds flagship_v5 (``adrates_torch/examples/flagship_v5.py``), its f64
and f32 ladder functions and their K1 inputs (Jv [n_grid + T, N] and the
per-trade tables), checks each kernel against its plain twin (1e-12 and
1e-5 x max|ref|), then times them in turns (f64, f32, f32, f64), each
turn 30 calls by CUDA events around the call and 30 by the device time
of the kernel in one torch.profiler trace, beside one cuSPARSE SpMM of
the same dtype and each kernel's bound (bytes over 3.35 TB/s). Prints
each kernel's registers (``cuobjdump -res-usage``) and one JSON line.
The timing helpers are ``chip_smoke.py``'s.
"""

import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def main() -> int:
    sys.path.insert(0, str(HERE))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("k1_f32_ab: no CUDA device visible", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from adrates_torch.examples import flagship_v5 as cfg
    from adrates_torch.ops import kernels
    from adrates_torch.parallel import make_per_trade_delta_fn

    card = cs._card_line()
    kernels.build_kernels()
    cuobjdump = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) \
        / "bin" / "cuobjdump"
    res = subprocess.run([str(cuobjdump), "-res-usage",
                          str(kernels.library_path())],
                         capture_output=True, text=True)
    lines = res.stdout.splitlines()
    usage = {("f32" if "IfEE" in ln else "f64"): lines[i + 1].strip()
             for i, ln in enumerate(lines[:-1])
             if "pvs_sweep_kernel" in ln}
    dev = torch.device("cuda", 0)
    model = cfg.build_model()
    with warnings.catch_warnings():        # CHF has no trades
        warnings.simplefilter("ignore", UserWarning)
        mb, _ = cfg.build_book(model, np.random.default_rng(cfg.SEED))
    q0 = mb.basket.quotes0
    inputs = {}
    for name, dtype in (("f64", None), ("f32", torch.float32)):
        fn = make_per_trade_delta_fn(mb, dev, dtype=dtype)
        inputs[name] = (fn.prep(q0)[2], fn.sweep)
    out = dict(card=card, registers=usage, turns=[])
    for name, (Jv, tab) in inputs.items():
        ref = kernels.pvs_sweep_plain(Jv, tab)
        err = float((kernels.pvs_sweep(Jv, tab) - ref).abs().max()
                    / ref.abs().max())
        cs._check(f"K1 {name} vs plain {name} (abs / max|ref|)", err,
                  1e-12 if name == "f64" else 1e-5)
        M, S = Jv.shape
        B, nnz = tab.n_trades, int(tab.slot_w.numel())
        size = Jv.element_size()
        nbytes = 4 * (B + 1) + (4 + size) * nnz + size * (M * S + S * B)
        with warnings.catch_warnings():      # CSR support is "beta"
            warnings.simplefilter("ignore", UserWarning)
            csr = torch.sparse_csr_tensor(tab.tptr.long(), tab.slot_col(),
                                          tab.slot_w, size=(B, M))
        Jc = Jv.contiguous()
        lib = cs._device_stats(lambda: torch.sparse.mm(csr, Jc))
        out[name] = dict(
            shape=[M, S], trades=B, slots=nnz, max_rel_err=err,
            bound_ms=nbytes / cs.HBM_BPS * 1e3, mbytes=nbytes / 1e6,
            library_ms=cs._cuda_ms(lambda: torch.sparse.mm(csr, Jc)),
            library_device_ms=lib and lib["median"])
    for name in ("f64", "f32", "f32", "f64"):
        Jv, tab = inputs[name]
        f = lambda: kernels.pvs_sweep(Jv, tab)      # noqa: E731
        dv = cs._device_stats(f)
        out["turns"].append(dict(kernel=name, ms=cs._cuda_ms(f),
                                 device_ms=dv and dv["median"],
                                 kernels_per_call=dv and dv["kernels"]))
        print(f"K1 {name}: events {out['turns'][-1]['ms']:.4f} ms, device "
              f"{cs._fmt_ms(out['turns'][-1]['device_ms'])}; card {card}",
              flush=True)
    print(json.dumps({"k1_f32_ab": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
