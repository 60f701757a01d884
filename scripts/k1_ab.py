#!/usr/bin/env python3
"""K1 (``pvs_sweep``) of one checkout at every shape the port runs it at,
on one CUDA card.

    python3 scripts/k1_ab.py [ROOT] [--inputs FILE]

ROOT is a checkout of this repository (default: the one holding this
script); its ``adrates_torch`` is imported and its kernels built. The
shapes: the PV sweep of the three flagship books (the OIS slice, vT
[10,197, 100]; OIS + XCCY, [14,660, 100]; flagship_v5, [15,983, 100]),
the single-curve book (``chip_smoke.py`` phase 7e's 100,000 trades x 100
scenarios, vT [61, 100]) and flagship_v5's per-trade ladders (Jv
[15,983, 184] in f64 and in f32). With ``--inputs FILE`` the value tables
and K1 tables are read from FILE where it exists, else built (at q0 and
the books' own seeded shocks) and written there, with a digest of each
output beside them, so that two checkouts are timed on the same inputs
and their outputs compared bit for bit.

For each shape it calls K1 as the checkout's path calls it: the PV
sweep scenario-major ([S, B]); the ladders trade-major where the
checkout's ``pvs_sweep`` takes ``trade_major``, else scenario-major with
the ``.T.contiguous()`` the ladder path took after it (the parent's
design; that transpose is timed on its own too). It checks the result
against the plain twin (1e-12 x max|ref|; f32 1e-5), and times it 30
times by CUDA events around the call and 30 times by the device time of
its kernels in one torch.profiler trace, beside one cuSPARSE SpMM of the
same dtype. Prints the registers and shared memory of each K1 kernel
(``cuobjdump -res-usage``), one line a shape with the card's name and
power limit, and one JSON line. To compare commits, run parent, change,
change, parent in one call.
"""

import argparse
import hashlib
import importlib.util
import inspect
import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
FIELDS = ("n_trades", "n_cols", "tptr", "slot_row", "slot_w", "bptr",
          "brow")


def _host(tab) -> dict:
    return {k: (getattr(tab, k).cpu() if k not in ("n_trades", "n_cols")
                else getattr(tab, k)) for k in FIELDS}


def _capture(cs, dev) -> dict:
    """{shape: dict(vT, tables, trade_major)} on the CPU (``cs``: the
    ``chip_smoke`` module, whose phase 7e sizes the single-curve book)."""
    import numpy as np
    import torch

    from adrates_torch.examples import flagship_ois, flagship_ois_xccy
    from adrates_torch.examples import flagship_v5 as cfg
    from adrates_torch.examples import quickstart
    from adrates_torch.parallel import (compile_book, make_book_fn,
                                        make_per_trade_delta_fn, tile_book)
    from adrates_torch.parallel import multibook as tmb
    from adrates_torch.utils import CurrencyTypes
    out = {}

    def pv(name, mb, shocks):
        fn = tmb.make_multibook_fn(mb, device=dev)
        vT = tmb.value_table(fn.dfs_only(mb.basket.quotes0, shocks),
                             fn.book.aggregate)
        out[name] = dict(vT=vT.cpu(), tab=_host(fn.book.sweep),
                         trade_major=False)

    def tiled(model, base, scale, **kw):
        mb = tmb.compile_multibook(base, model,
                                   base_currency=CurrencyTypes.USD,
                                   n_buckets=4, stage_buckets="coarse", **kw)
        return tmb.tile_multibook(mb, len(scale), notional_scale=scale)

    rng = np.random.default_rng(flagship_ois.SEED)
    model = flagship_ois.build_model()
    base = flagship_ois.build_ois_trades(model, rng)
    scale = rng.uniform(0.5, 2.0, -(-flagship_ois.N_TRADES // len(base)))
    mb = tiled(model, base, scale)
    pv("ois_slice", mb, rng.normal(0.0, 1e-3, (flagship_ois.N_SCENARIOS,
                                                mb.basket.n_quotes)))
    rng = np.random.default_rng(flagship_ois_xccy.SEED)
    model = flagship_ois_xccy.build_model()
    base, coll = flagship_ois_xccy.build_trades(model, rng)
    scale = rng.uniform(0.5, 2.0, flagship_ois_xccy.N_TRADES // len(base))
    mb = tiled(model, base, scale, collateral_types=coll)
    pv("ois_xccy_book", mb, rng.normal(
        0.0, 1e-3, (flagship_ois_xccy.N_SCENARIOS, mb.basket.n_quotes)))
    model = cfg.build_model()
    with warnings.catch_warnings():        # CHF has no trades
        warnings.simplefilter("ignore", UserWarning)
        mb, shocks = cfg.build_book(model, np.random.default_rng(cfg.SEED))
    pv("flagship_v5", mb, shocks)
    for name, dtype in (("flagship_v5_ladders", None),
                        ("flagship_v5_ladders_f32", torch.float32)):
        fn = make_per_trade_delta_fn(mb, dev, dtype=dtype)
        out[name] = dict(vT=fn.prep(mb.basket.quotes0)[2].cpu(),
                         tab=_host(fn.book.sweep), trade_major=True)
    # chip_smoke.py phase 7e's single-curve book
    curve = model.curves.GBP_OIS_SONIA
    q = np.asarray(curve.swap_rates)
    book = compile_book(quickstart.book_swaps(np.random.default_rng(0)),
                        model.value_dt)
    rng = np.random.default_rng(7)
    n = cs.BOOK_COPIES
    book = tile_book(book, n, coupon_scale=rng.uniform(0.5, 1.5, n),
                     notional_scale=rng.uniform(0.5, 1.5, n))
    shocks = rng.normal(0.0, 1e-3, (100, q.shape[0]))
    fn = make_book_fn(curve._plan, curve._interp_type, device=dev)
    vT, bt = fn.value_table(torch.as_tensor(q, device=dev), book,
                            torch.as_tensor(shocks, device=dev))
    out["single_curve_book"] = dict(vT=vT.cpu(), tab=_host(bt.sweep),
                                    trade_major=False)
    return out


def _digest(t) -> str:
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()
                          ).hexdigest()[:16]


def _usage(kernels) -> dict:
    """Registers and shared memory of each K1 kernel of the library."""
    cuobjdump = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) \
        / "bin" / "cuobjdump"
    res = subprocess.run([str(cuobjdump), "-res-usage",
                          str(kernels.library_path())],
                         capture_output=True, text=True)
    lines = res.stdout.splitlines()
    return {ln.split("Function ")[-1].rstrip(":"): lines[i + 1].strip()
            for i, ln in enumerate(lines[:-1]) if "pvs_sweep" in ln}


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?", default=str(HERE))
    ap.add_argument("--inputs")
    args = ap.parse_args(argv[1:])
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch
    if not torch.cuda.is_available():
        print("k1_ab: no CUDA device visible", file=sys.stderr)
        return 2
    import adrates_torch
    if root not in Path(adrates_torch.__file__).resolve().parents:
        raise AssertionError(f"imported {adrates_torch.__file__}, not from "
                             f"{root}")
    from adrates_torch.ops import kernels
    kernels.build_kernels()
    dev = torch.device("cuda", 0)
    has_tm = "trade_major" in inspect.signature(kernels.pvs_sweep).parameters
    inputs = Path(args.inputs) if args.inputs else None
    if inputs is not None and inputs.exists():
        data = torch.load(inputs)
        captured = False
    else:
        data = _capture(cs, dev)
        captured = True
    card = cs._card_line()
    out = dict(root=str(root), card=card, captured=captured,
               trade_major_kernel=has_tm, registers=_usage(kernels),
               shapes={})
    for k, v in out["registers"].items():
        print(f"{k}: {v}", flush=True)
    for shape, d in data.items():
        vT = d["vT"].to(dev)
        tab = kernels.SweepTables(**{
            k: (d["tab"][k] if k in ("n_trades", "n_cols")
                else d["tab"][k].to(dev)) for k in FIELDS})
        tab = kernels.sweep_tables_as(tab, vT.dtype)
        if d["trade_major"] and has_tm:
            def call():
                return kernels.pvs_sweep(vT, tab, trade_major=True)
        elif d["trade_major"]:
            def call():
                return kernels.pvs_sweep(vT, tab).T.contiguous()
        else:
            def call():
                return kernels.pvs_sweep(vT, tab)
        f32 = vT.dtype == torch.float32
        ref = kernels.pvs_sweep_plain(vT, tab)
        ref = ref.T.contiguous() if d["trade_major"] else ref
        got = call()
        err = float((got - ref).abs().max() / ref.abs().max())
        cs._check(f"{shape} K1 vs plain (abs / max|ref|)", err,
                  1e-5 if f32 else 1e-12)
        digest = _digest(got)
        d.setdefault("digest", digest)
        with warnings.catch_warnings():      # CSR support is "beta"
            warnings.simplefilter("ignore", UserWarning)
            csr = torch.sparse_csr_tensor(tab.tptr.long(), tab.slot_col(),
                                          tab.slot_w, size=(tab.n_trades,
                                                            vT.shape[0]))
        vc = vT.contiguous()
        rec = dict(shape=list(vT.shape), trades=tab.n_trades,
                   slots=int(tab.slot_w.numel()), dtype=str(vT.dtype),
                   trade_major=d["trade_major"], err=err, digest=digest,
                   bit_for_bit_with_first=digest == d["digest"],
                   events=cs._cuda_stats(call),
                   device=cs._device_stats(call),
                   library_device=cs._device_stats(
                       lambda: torch.sparse.mm(csr, vc)))
        if d["trade_major"] and not has_tm:
            sm = kernels.pvs_sweep(vT, tab)
            rec["transpose_device"] = cs._device_stats(
                lambda: sm.T.contiguous())
            del sm
        if d["trade_major"] and has_tm:
            plan = kernels.sweep_plan(vT.shape[1], vT.dtype)
            rec["plan"] = dict(vars(plan))
        out["shapes"][shape] = rec
        dv, tr, lib = (rec.get(k) for k in ("device", "transpose_device",
                                             "library_device"))
        print(f"{shape} {rec['shape']} {rec['dtype']}"
              f"{' trade-major' if has_tm and d['trade_major'] else ''}: "
              f"device {cs._fmt_ms(dv and dv['median'])} "
              f"({dv and dv['kernels']} kernels), events "
              f"{rec['events']['median']:.4f} ms"
              + (f", of which the transpose {cs._fmt_ms(tr['median'])}"
                 if tr else "")
              + f"; cuSPARSE {cs._fmt_ms(lib and lib['median'])}; err "
              f"{err:.1e}, digest {digest}, bit for bit with the first run "
              f"{rec['bit_for_bit_with_first']}; card {card}", flush=True)
        del vT, vc, csr, got, ref
        torch.cuda.empty_cache()
    if captured and inputs is not None:
        inputs.parent.mkdir(parents=True, exist_ok=True)
        torch.save(data, inputs)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
