#!/usr/bin/env python3
"""Smoke run of the adrates_torch book-risk path on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` (on PATH or under $CUDA_HOME) and
``nvidia-smi``; it builds the CUDA kernels from ``adrates_torch/csrc`` on
first use. Phases:

1. environment: the card's name and power limit, torch/CUDA/nvcc versions;
2. build: compile and load the kernels (K1 pvs_sweep, K2 gamma quad form);
3. slice: the flagship OIS book (7 curves, N = 144 quotes, 720 OIS tiled
   to 100,080 trades, 100 scenarios) through ``make_multibook_fn`` on the
   card: one cold call, then 3 warm calls;
4. checks on the slice's outputs: finite, gamma symmetric, per-scenario
   sum of trade PVs equal to the aggregate total, delta against a central
   finite difference, both kernels launched on the main path, zero risk
   on CHF (a curve with no trades);
5. each kernel against its plain torch twin on the card, at the shapes
   the main path gives it, with both times (CUDA events, median);
6. the kernels' JSON line, the card line, and the final JSON line.

Any failed check raises, so the script exits non-zero and prints no
result. It exits non-zero at once when no CUDA card is visible.
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


def run_slice(device, n_copies: int, n_scen: int, n_warm: int = 3):
    """Phases 3 and 4: build, run and check the slice on ``device``.
    Returns (fn, mb, q0, shocks, out, info); ``info`` holds the main
    path's launch counts and its cold and warm times."""
    import numpy as np
    import torch

    from adrates_torch.examples import flagship_ois as cfg
    from adrates_torch.ops import kernels
    from adrates_torch.parallel.multibook import (aggregate_total,
                                                  compile_multibook,
                                                  make_multibook_fn,
                                                  tile_multibook)
    from adrates_torch.utils import CurrencyTypes

    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" \
        else (lambda: None)
    rng = np.random.default_rng(cfg.SEED)
    t0 = time.perf_counter()
    model = cfg.build_model()
    t_model = time.perf_counter() - t0
    t0 = time.perf_counter()
    base = cfg.build_ois_trades(model, rng)
    mb_base = compile_multibook(base, model,
                                base_currency=CurrencyTypes.USD,
                                n_buckets=4, stage_buckets="coarse")
    mb = tile_multibook(mb_base, n_copies,
                        notional_scale=rng.uniform(0.5, 2.0, n_copies))
    t_compile = time.perf_counter() - t0
    N = mb.basket.n_quotes
    shocks = rng.normal(0.0, 1e-3, (n_scen, N))
    q0 = mb.basket.quotes0
    print(f"slice: {len(model._curves_dict)} curves built with refit "
          f"gates in {t_model * 1e3:.1f} ms; {len(base)} OIS compiled and "
          f"tiled x{n_copies} to {mb.n_trades} trades in "
          f"{t_compile * 1e3:.1f} ms", flush=True)
    print(f"slice: N={N} n_grid={mb.basket.n_grid} "
          f"unique_times={mb.unique_times.shape[0]} "
          f"T={mb.aggregate.trip_s.shape[0]} S={n_scen} "
          f"col buckets [R, L]="
          f"{[list(cb.col_idx.shape) for cb in mb.cols]} (base rows, "
          f"x{n_copies} on the device)", flush=True)

    t0 = time.perf_counter()
    fn = make_multibook_fn(mb, device=device)
    sync()
    t_build = time.perf_counter() - t0
    chunk = fn.chunk(n_scen)
    j_mib = chunk * N * mb.basket.n_grid * 8 / 2**20
    print(f"slice: make_multibook_fn {t_build * 1e3:.1f} ms; risk chunk "
          f"{chunk} scenarios (J stack {j_mib:.1f} MiB); "
          f"{len(fn.book.groups)} trip groups of k="
          f"{[int(g['rows'].shape[0]) for g in fn.book.groups]}",
          flush=True)

    kernels.pvs_sweep.launches = 0
    kernels.gamma_quad_form_grouped.launches = 0
    t0 = time.perf_counter()
    out = fn(q0, shocks)
    sync()
    cold_ms = (time.perf_counter() - t0) * 1e3
    warm = []
    for _ in range(n_warm):
        t0 = time.perf_counter()
        out = fn(q0, shocks)
        sync()
        warm.append((time.perf_counter() - t0) * 1e3)
    launches = {"pvs_sweep": kernels.pvs_sweep.launches,
                "gamma_quad_form_grouped":
                    kernels.gamma_quad_form_grouped.launches}
    print(f"slice: main path cold {cold_ms:.1f} ms, warm "
          f"{[round(w, 1) for w in warm]} ms (median "
          f"{statistics.median(warm):.1f} ms); launches {launches}",
          flush=True)

    # ---- phase 4: checks on the outputs -------------------------------
    pvs, delta, gamma = out["pvs"], out["delta"], out["gamma"]
    if tuple(pvs.shape) != (n_scen, mb.n_trades) \
            or tuple(delta.shape) != (n_scen, N) \
            or tuple(gamma.shape) != (n_scen, N, N):
        raise AssertionError(f"shapes {pvs.shape} {delta.shape} "
                             f"{gamma.shape}")
    for k, v in out.items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{k} has non-finite entries")
    _check("gamma symmetry (rel)",
           float((gamma - gamma.transpose(1, 2)).abs().max()
                 / gamma.abs().max()), 1e-10)

    book = fn.book
    dfs = fn.dfs_only(q0, shocks)
    totals = torch.stack([aggregate_total(dfs[s], book.aggregate,
                                          book.clamp_agg)
                          for s in range(n_scen)])
    _check("sum_b pvs == aggregate total (rel)",
           float(((pvs.sum(dim=1) - totals).abs()
                  / totals.abs()).max()), 1e-9)

    def total_at(q):
        return float(aggregate_total(book.grids(q, book.params),
                                     book.aggregate, book.clamp_agg))

    h = 1e-6
    q = torch.as_tensor(q0 + shocks[0], dtype=torch.float64, device=device)
    for i in torch.argsort(delta[0].abs(), descending=True)[:3].tolist():
        e = torch.zeros_like(q)
        e[i] = h
        fd = (total_at(q + e) - total_at(q - e)) / (2 * h)
        _check(f"delta[0, {i}] vs central FD (rel)",
               abs(fd - float(delta[0, i])) / abs(fd), 1e-5)

    chf = mb.basket.quote_slice("CHF_OIS_SARON")
    if not bool((delta[:, chf] == 0).all()):
        raise AssertionError("CHF delta columns are not exactly zero")
    print("check CHF delta columns (no CHF trades): exactly zero",
          flush=True)
    return fn, mb, q0, shocks, out, dict(launches, cold_ms=cold_ms,
                                         warm_ms=warm)


def compare_kernels(fn, q0, shocks):
    """Phase 5: each kernel against its plain twin at the main path's
    shapes; returns the kernels' records (without launch counts)."""
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
    _check("K1 pvs_sweep vs plain (abs / max|ref|)",
           err1 / float(ref.abs().max()), 1e-12)
    ms1 = _cuda_ms(lambda: kernels.pvs_sweep(vT, bks, book.tri))
    pms1 = _cuda_ms(lambda: kernels.pvs_sweep_plain(vT, bks, book.tri))
    print(f"K1 pvs_sweep [M, S]={list(vT.shape)} B={book.tri.shape[0]}: "
          f"kernel {ms1:.3f} ms, plain {pms1:.3f} ms", flush=True)

    c = fn.chunk(shocks.shape[0])
    dfs_c, J = fn.jacobians(q0, shocks[:c])
    ref = kernels.gamma_quad_form_grouped_plain(J, dfs_c, book.groups)
    got = kernels.gamma_quad_form_grouped(J, dfs_c, book.groups)
    err2 = float((got - ref).abs().max())
    _check("K2 gamma_quad_form_grouped vs plain (abs / max|ref|)",
           err2 / float(ref.abs().max()), 1e-12)
    ms2 = _cuda_ms(lambda: kernels.gamma_quad_form_grouped(
        J, dfs_c, book.groups))
    pms2 = _cuda_ms(lambda: kernels.gamma_quad_form_grouped_plain(
        J, dfs_c, book.groups))
    print(f"K2 gamma_quad_form_grouped J={list(J.shape)}: kernel "
          f"{ms2:.3f} ms, plain {pms2:.3f} ms", flush=True)
    return [
        dict(name="pvs_sweep", route="cuda",
             source="adrates_torch/csrc/pvs_sweep.cu",
             replaces="adrates_tpu/parallel/multibook.py:1782",
             max_abs_err=err1, ms=ms1, plain_ms=pms1),
        dict(name="gamma_quad_form_grouped", route="cuda",
             source="adrates_torch/csrc/gamma_quad_form.cu",
             replaces="adrates_tpu/parallel/multibook.py:1660",
             max_abs_err=err2, ms=ms2, plain_ms=pms2),
    ]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    from adrates_torch.examples import flagship_ois as cfg
    from adrates_torch.ops import kernels

    # ---- phase 1: environment ------------------------------------------
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

    # ---- phases 3-4 ------------------------------------------------------
    n_copies = -(-cfg.N_TRADES // 720)
    fn, mb, q0, shocks, out, info = run_slice(device, n_copies,
                                              cfg.N_SCENARIOS)
    for name in ("pvs_sweep", "gamma_quad_form_grouped"):
        if info[name] <= 0:
            raise AssertionError(f"{name} was not launched on the main "
                                 f"path")

    # ---- phase 5 -------------------------------------------------------
    records = compare_kernels(fn, q0, shocks)
    for r in records:
        r["launches"] = info[r["name"]]
    torch.cuda.synchronize()

    # ---- phase 6 -------------------------------------------------------
    print(json.dumps({"kernels": records}))
    print(f"card: {_card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
