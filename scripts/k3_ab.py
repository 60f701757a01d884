#!/usr/bin/env python3
"""K3 (``pertrade_quad_form``) of one checkout on flagship_v5's two
per-trade paths, on one CUDA card.

    python3 scripts/k3_ab.py [ROOT]

ROOT is a checkout of this repository (default: the one holding this
script); its ``adrates_torch`` is imported and its kernels built. The
flagship_v5 book, the 256 selected trades and the timing helpers come
from this checkout's ``chip_smoke.py``, so two checkouts are timed on the
same inputs and clocks. For the 256 selected trades (k = 184) and every
trade's own block it checks the kernel against its plain twin, then
times it 30 times by CUDA events around the call (which hold the
wrapper's host work) and 30 times by the device time of the kernels in
one torch.profiler trace, beside the padded ``torch.bmm`` yardstick and
the bound. Prints one JSON line. To compare commits, run parent, change,
change, parent in one call.
"""

import importlib.util
import json
import sys
import warnings
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


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
        print("k3_ab: no CUDA device visible", file=sys.stderr)
        return 2
    import adrates_torch
    if root not in Path(adrates_torch.__file__).resolve().parents:
        raise AssertionError(f"imported {adrates_torch.__file__}, not from "
                             f"{root}")
    from adrates_torch.examples import flagship_v5 as cfg
    from adrates_torch.ops import kernels
    from adrates_torch.parallel import (make_per_trade_gamma_blocks_fn,
                                        make_per_trade_gamma_fn)
    kernels.build_kernels()
    dev = torch.device("cuda", 0)
    model = cfg.build_model()
    with warnings.catch_warnings():        # CHF has no trades
        warnings.simplefilter("ignore", UserWarning)
        mb, _ = cfg.build_book(model, np.random.default_rng(cfg.SEED))
    q0 = mb.basket.quotes0
    sel, _, _ = cs._select_trades(mb)
    out = dict(root=str(root), card=cs._card_line(), paths={})
    for path, make in (
            ("flagship_v5_gamma_256",
             lambda: make_per_trade_gamma_fn(mb, sel, dev)),
            ("flagship_v5_gamma_blocks",
             lambda: make_per_trade_gamma_blocks_fn(mb, dev))):
        fn = make()
        _, dfs, Jt, w = fn.prep(q0)
        t = fn.k3
        ref = kernels.pertrade_quad_form_plain(Jt, dfs, w, t)
        got = kernels.pertrade_quad_form(Jt, dfs, w, t)
        scale = max(float(r.abs().max()) for r in ref)
        err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        cs._check(f"{path} K3 vs plain (abs / max|ref|)", err / scale,
                  1e-12)

        def call():
            return kernels.pertrade_quad_form(Jt, dfs, w, t)

        L, R = cs._k3_operands(Jt, dfs, w, t)
        Lt = L.transpose(1, 2)
        nbytes, flops, _, _ = cs._k3_bytes_flops(t, *Jt.shape)
        bound, by = cs._bound(nbytes, flops, cs.FP64_TC_FLOPS)
        rec = dict(err=err / scale, events=cs._cuda_stats(call),
                   device=cs._device_stats(call),
                   bmm_events=cs._cuda_stats(lambda: torch.bmm(Lt, R)),
                   bmm_device=cs._device_stats(lambda: torch.bmm(Lt, R)),
                   bound_ms=bound, bound_by=by)
        out["paths"][path] = rec
        print(f"{path}: K3 events {rec['events']['median']:.4f} ms, device "
              f"{cs._fmt_ms(rec['device'] and rec['device']['median'])}; "
              f"bmm events {rec['bmm_events']['median']:.4f} ms; bound "
              f"{bound * 1e3:.1f} us ({by}); card {out['card']}",
              flush=True)
        del L, R, Lt, ref, got, fn
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
