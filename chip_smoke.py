#!/usr/bin/env python3
"""Smoke run of the adrates_torch book-risk paths on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` (on PATH or under $CUDA_HOME) and
``nvidia-smi``; it builds the CUDA kernels from ``adrates_torch/csrc`` on
first use. Phases:

1. environment: the card's name and power limit, torch/CUDA/nvcc versions;
2. build: compile and load the kernels (K1 pvs_sweep, K2 gamma quad form);
3. OIS slice: the flagship OIS book (7 curves, N = 144 quotes, 720 OIS
   tiled to 100,080 trades, 100 scenarios) through ``make_multibook_fn``
   on the structured risk split: one cold call, then 3 warm calls;
4. checks on its outputs: finite, gamma symmetric, per-scenario sum of
   trade PVs equal to the aggregate total, delta against a central
   finite difference, both kernels launched, zero risk on CHF (a curve
   with no trades);
5. the same slice through the generic split (``batch_curves=False``):
   cold and warm calls, launches, and its delta and gamma against the
   structured route's;
6. OIS + XCCY book: 7 OIS + 3 XCCY curves (N = 168), 800 trades tiled to
   100,000, 100 scenarios, through ``warmup_multibook(staged=True)``
   and 3 warm calls of ``make_staged_multibook_fn``, with the checks of
   phase 4 (the FD delta also on the largest XCCY basis quote), each
   region's time, and the staged outputs against ``make_multibook_fn``;
7. each kernel against its plain torch twin on the card, at the shapes
   each path gives it, with both times (CUDA events, median);
8. the kernels' JSON line, the card line, and the final JSON line.

Each path's kernel launch counts are set to 0 just before it runs and
read just after. Any failed check raises, so the script exits non-zero
and prints no result. It exits non-zero at once when no CUDA card is
visible.
"""

import json
import statistics
import subprocess
import sys
import time


def _card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return res.stdout.strip().splitlines()[0]


def _cuda_ms(f, reps: int = 10) -> float:
    """Median device milliseconds of ``f()`` over ``reps`` runs (CUDA
    events), after one warm-up run."""
    import torch
    f()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        f()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _check(name: str, err: float, bound: float):
    print(f"check {name}: {err:.3e} (bound {bound:.1e})", flush=True)
    if not err <= bound:
        raise AssertionError(f"check {name} failed: {err!r} > {bound!r}")


def _reset_launches():
    from adrates_torch.ops import kernels
    kernels.pvs_sweep.launches = 0
    kernels.gamma_quad_form_grouped.launches = 0


def _launches() -> dict:
    from adrates_torch.ops import kernels
    return {"pvs_sweep": kernels.pvs_sweep.launches,
            "gamma_quad_form_grouped":
                kernels.gamma_quad_form_grouped.launches}


def _timed(f):
    import torch
    t0 = time.perf_counter()
    out = f()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _drive(name, fn, q0, shocks, n_warm, cold=None):
    """One path: launch counts from 0, a cold call (or the given
    (out, ms) of one), ``n_warm`` warm calls; returns (out, info)."""
    import torch
    if cold is None:
        _reset_launches()
        torch.cuda.reset_peak_memory_stats()
        out, cold_ms = _timed(lambda: fn(q0, shocks))
    else:
        out, cold_ms = cold
    warm = []
    for _ in range(n_warm):
        out, ms = _timed(lambda: fn(q0, shocks))
        warm.append(ms)
    info = dict(_launches(), cold_ms=cold_ms, warm_ms=warm,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    print(f"{name}: cold {cold_ms:.1f} ms, warm "
          f"{[round(w, 1) for w in warm]} ms (median "
          f"{statistics.median(warm):.1f} ms); launches "
          f"{_launches()}; peak {info['peak_gib']:.2f} GiB", flush=True)
    return out, info


def check_outputs(name, out, fn, q0, shocks, n_trades, fd_extra=()):
    """Phase-4 gates on one path's outputs; ``fn`` is a
    make_multibook_fn of the same book (its grids and aggregate)."""
    import torch

    from adrates_torch.parallel.multibook import aggregate_total

    S, N = shocks.shape
    pvs, delta, gamma = out["pvs"], out["delta"], out["gamma"]
    if tuple(pvs.shape) != (S, n_trades) or tuple(delta.shape) != (S, N) \
            or tuple(gamma.shape) != (S, N, N):
        raise AssertionError(f"{name}: shapes {pvs.shape} {delta.shape} "
                             f"{gamma.shape}")
    for k, v in out.items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{name}: {k} has non-finite entries")
    _check(f"{name} gamma symmetry (rel)",
           float((gamma - gamma.transpose(1, 2)).abs().max()
                 / gamma.abs().max()), 1e-10)

    book = fn.book
    dfs = fn.dfs_only(q0, shocks)
    totals = torch.stack([aggregate_total(dfs[s], book.aggregate,
                                          book.clamp_agg)
                          for s in range(S)])
    _check(f"{name} sum_b pvs == aggregate total (rel)",
           float(((pvs.sum(dim=1) - totals).abs()
                  / totals.abs()).max()), 1e-9)

    def total_at(q):
        return float(aggregate_total(book.grids(q, book.params),
                                     book.aggregate, book.clamp_agg))

    h = 1e-6
    q = torch.as_tensor(q0 + shocks[0], dtype=torch.float64,
                        device=delta.device)
    idx = torch.argsort(delta[0].abs(), descending=True)[:3].tolist()
    for i in idx + [i for i in fd_extra if i not in idx]:
        e = torch.zeros_like(q)
        e[i] = h
        fd = (total_at(q + e) - total_at(q - e)) / (2 * h)
        _check(f"{name} delta[0, {i}] vs central FD (rel)",
               abs(fd - float(delta[0, i])) / abs(fd), 1e-5)


def _compile(model, trades, scale, **kw):
    """The book in USD, tiled by the per-copy notional ``scale``."""
    from adrates_torch.parallel.multibook import (compile_multibook,
                                                  tile_multibook)
    from adrates_torch.utils import CurrencyTypes
    mb = compile_multibook(trades, model, base_currency=CurrencyTypes.USD,
                           n_buckets=4, stage_buckets="coarse", **kw)
    return tile_multibook(mb, len(scale), notional_scale=scale)


def _describe(name, mb, fn, n_scen, t_model, t_compile, n_base):
    N = mb.basket.n_quotes
    print(f"{name}: {len(mb.basket.specs)} curves built with refit gates "
          f"in {t_model * 1e3:.1f} ms; {n_base} trades compiled and tiled "
          f"to {mb.n_trades} in {t_compile * 1e3:.1f} ms", flush=True)
    print(f"{name}: N={N} n_grid={mb.basket.n_grid} "
          f"unique_times={mb.unique_times.shape[0]} "
          f"T={mb.aggregate.trip_s.shape[0]} S={n_scen} col buckets "
          f"[R, L]={[list(cb.col_idx.shape) for cb in mb.cols]} (base "
          f"rows); chunk {fn.chunk(n_scen)}; {len(fn.book.groups)} trip "
          f"groups of k={[int(g['rows'].shape[0]) for g in fn.book.groups]}"
          f"; stages {[(st.kind, len(st.ids)) for st in mb.basket.stages]}",
          flush=True)


def run_ois_slice(device, n_warm: int = 3):
    """Phases 3-5: the OIS slice on the structured and generic routes."""
    import numpy as np
    import torch

    from adrates_torch.examples import flagship_ois as cfg
    from adrates_torch.parallel.multibook import make_multibook_fn

    rng = np.random.default_rng(cfg.SEED)
    t0 = time.perf_counter()
    model = cfg.build_model()
    t_model = time.perf_counter() - t0
    t0 = time.perf_counter()
    base = cfg.build_ois_trades(model, rng)
    scale = rng.uniform(0.5, 2.0, -(-cfg.N_TRADES // len(base)))
    mb = _compile(model, base, scale)
    t_compile = time.perf_counter() - t0
    shocks = rng.normal(0.0, 1e-3, (cfg.N_SCENARIOS, mb.basket.n_quotes))
    q0 = mb.basket.quotes0

    fn = make_multibook_fn(mb, device=device)
    if not fn.structured:
        raise AssertionError("the OIS slice did not take the structured "
                             "split")
    _describe("ois", mb, fn, cfg.N_SCENARIOS, t_model, t_compile,
              len(base))
    out, info = _drive("ois structured", fn, q0, shocks, n_warm)
    check_outputs("ois", out, fn, q0, shocks, mb.n_trades)
    chf = mb.basket.quote_slice("CHF_OIS_SARON")
    if not bool((out["delta"][:, chf] == 0).all()):
        raise AssertionError("CHF delta columns are not exactly zero")
    print("check ois CHF delta columns (no CHF trades): exactly zero",
          flush=True)

    # ---- phase 5: the generic route at the same shapes ---------------
    mb_gen = _compile(model, base, scale, batch_curves=False)
    fn_gen = make_multibook_fn(mb_gen, device=device)
    if fn_gen.structured:
        raise AssertionError("batch_curves=False took the structured split")
    out_gen, info_gen = _drive("ois generic", fn_gen, q0, shocks,
                               max(n_warm - 1, 1))
    for k, bound in (("delta", 1e-9), ("gamma", 1e-8)):
        ref = out[k]
        _check(f"ois generic vs structured {k} (abs / max|ref|)",
               float((out_gen[k] - ref).abs().max() / ref.abs().max()),
               bound)
    del out_gen, fn_gen
    torch.cuda.empty_cache()
    return fn, mb, q0, shocks, info, info_gen


def run_xccy_book(device, n_warm: int = 3):
    """Phase 6: the OIS + XCCY book through the staged regions."""
    import numpy as np
    import torch

    from adrates_torch.examples import flagship_ois_xccy as cfg
    from adrates_torch.parallel.multibook import (make_multibook_fn,
                                                  warmup_multibook)

    rng = np.random.default_rng(cfg.SEED)
    t0 = time.perf_counter()
    model = cfg.build_model()
    t_model = time.perf_counter() - t0
    t0 = time.perf_counter()
    base, coll = cfg.build_trades(model, rng)
    scale = rng.uniform(0.5, 2.0, cfg.N_TRADES // len(base))
    mb = _compile(model, base, scale, collateral_types=coll)
    t_compile = time.perf_counter() - t0
    N = mb.basket.n_quotes
    shocks = rng.normal(0.0, 1e-3, (cfg.N_SCENARIOS, N))
    q0 = mb.basket.quotes0

    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    fn, cold_ms = _timed(lambda: warmup_multibook(
        mb, cfg.N_SCENARIOS, device, staged=True))
    _describe("xccy", mb, fn, cfg.N_SCENARIOS, t_model, t_compile,
              len(base))
    out, info = _drive("xccy staged", fn, q0, shocks, n_warm,
                       cold=(None, cold_ms))

    # per-region times on one warm chunk
    sh = torch.as_tensor(shocks[:fn.chunk(cfg.N_SCENARIOS)],
                         device=device)
    q = torch.as_tensor(q0, device=device)[None, :] + sh
    r = fn.regions
    a, ms_a = _timed(lambda: r["A"](q))
    t1, ms_b = _timed(lambda: r["B"](a["J"], a["dfs"]))
    (h2x, v_of), ms_c1 = _timed(lambda: r["C1"](q, a["g"], a["carry"]))
    h2o, ms_c2 = _timed(lambda: r["C2"](q, a["g"], v_of))
    _, ms_d = _timed(lambda: r["D"](t1, h2x, h2o))
    _, ms_p = _timed(lambda: r["P"](a["dfs"]))
    info["regions_ms"] = dict(A=ms_a, B=ms_b, C1=ms_c1, C2=ms_c2, D=ms_d,
                              P=ms_p)
    print(f"xccy regions (chunk {q.shape[0]}): "
          f"{ {k: round(v, 2) for k, v in info['regions_ms'].items()} } ms",
          flush=True)
    del a, t1, h2x, v_of, h2o

    mono = make_multibook_fn(mb, device=device)
    basis = min(s.offset for s in mb.basket.specs if s.kind == "xccy")
    top_basis = basis + int(out["delta"][0, basis:].abs().argmax())
    check_outputs("xccy", out, mono, q0, shocks, mb.n_trades,
                  fd_extra=(top_basis,))
    ref = mono(q0, shocks)
    for k in ("pvs", "delta", "gamma"):
        _check(f"xccy staged vs make_multibook_fn {k} (abs / max|ref|)",
               float((out[k] - ref[k]).abs().max() / ref[k].abs().max()),
               1e-10)
    del ref
    return mono, mb, q0, shocks, info


def compare_kernels(path, fn, q0, shocks):
    """Phase 7: each kernel against its plain twin at one path's shapes;
    returns the kernels' records (without launch counts)."""
    import torch

    from adrates_torch.ops import kernels
    from adrates_torch.parallel.multibook import _trip_values

    book = fn.book
    dfs = fn.dfs_only(q0, shocks)
    vT = torch.cat([dfs, _trip_values(dfs, book.aggregate)],
                   dim=1).T.contiguous()
    bks = [(cb.col_idx, cb.w) for cb in book.cols]
    ref = kernels.pvs_sweep_plain(vT, bks, book.tri)
    got = kernels.pvs_sweep(vT, bks, book.tri)
    err1 = float((got - ref).abs().max())
    _check(f"{path} K1 pvs_sweep vs plain (abs / max|ref|)",
           err1 / float(ref.abs().max()), 1e-12)
    ms1 = _cuda_ms(lambda: kernels.pvs_sweep(vT, bks, book.tri))
    pms1 = _cuda_ms(lambda: kernels.pvs_sweep_plain(vT, bks, book.tri))
    print(f"{path} K1 pvs_sweep [M, S]={list(vT.shape)} "
          f"B={book.tri.shape[0]}: kernel {ms1:.3f} ms, plain "
          f"{pms1:.3f} ms", flush=True)
    del vT, ref, got

    c = fn.chunk(shocks.shape[0])
    dfs_c, J = fn.jacobians(q0, shocks[:c])
    J = J.contiguous()
    ref = kernels.gamma_quad_form_grouped_plain(J, dfs_c, book.groups)
    got = kernels.gamma_quad_form_grouped(J, dfs_c, book.groups)
    err2 = float((got - ref).abs().max())
    _check(f"{path} K2 gamma_quad_form_grouped vs plain (abs / max|ref|)",
           err2 / float(ref.abs().max()), 1e-12)
    ms2 = _cuda_ms(lambda: kernels.gamma_quad_form_grouped(
        J, dfs_c, book.groups))
    pms2 = _cuda_ms(lambda: kernels.gamma_quad_form_grouped_plain(
        J, dfs_c, book.groups))
    print(f"{path} K2 gamma_quad_form_grouped J={list(J.shape)}: kernel "
          f"{ms2:.3f} ms, plain {pms2:.3f} ms", flush=True)
    del J, ref, got
    torch.cuda.empty_cache()
    return [
        dict(name="pvs_sweep", path=path, route="cuda",
             source="adrates_torch/csrc/pvs_sweep.cu",
             replaces="adrates_tpu/parallel/multibook.py:1782",
             max_abs_err=err1, ms=ms1, plain_ms=pms1),
        dict(name="gamma_quad_form_grouped", path=path, route="cuda",
             source="adrates_torch/csrc/gamma_quad_form.cu",
             replaces="adrates_tpu/parallel/multibook.py:1660",
             max_abs_err=err2, ms=ms2, plain_ms=pms2),
    ]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    from adrates_torch.ops import kernels

    # ---- phase 1: environment ------------------------------------------
    t_start = time.perf_counter()
    card = _card_line()
    nvcc = subprocess.run([kernels._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, nvcc: {nvcc.splitlines()[-1]}",
          flush=True)
    device = torch.device("cuda", 0)

    # ---- phase 2: build ------------------------------------------------
    secs = kernels.build_kernels()
    print(f"build: K1 + K2 built and loaded in {secs:.2f} s "
          f"({kernels.library_path().name})", flush=True)

    # ---- phases 3-6 ------------------------------------------------------
    fn_o, _, q_o, sh_o, info_o, info_g = run_ois_slice(device)
    fn_x, _, q_x, sh_x, info_x = run_xccy_book(device)
    for path, info in (("ois_slice", info_o), ("ois_slice_generic", info_g),
                       ("ois_xccy_book", info_x)):
        for name in ("pvs_sweep", "gamma_quad_form_grouped"):
            if info[name] <= 0:
                raise AssertionError(f"{name} was not launched on the "
                                     f"{path} path")

    # ---- phase 7 -------------------------------------------------------
    records = compare_kernels("ois_slice", fn_o, q_o, sh_o) \
        + compare_kernels("ois_xccy_book", fn_x, q_x, sh_x)
    for r in records:
        r["launches"] = (info_o if r["path"] == "ois_slice"
                         else info_x)[r["name"]]
    torch.cuda.synchronize()
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)

    # ---- phase 8 -------------------------------------------------------
    print(json.dumps({"kernels": records}))
    print(f"card: {_card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
