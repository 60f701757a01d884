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
7. flagship_v5, the whole book of the repository's ``bench.py``: 12
   curves (7 OIS + 3 XCCY + 2 inflation, N = 184), 1,004 trades of every
   kind (FRNs with cap/floor clamp slots, bonds, ZCIS and YoY, fix-float
   and fix-fix XCCY) tiled to 100,400, 100 scenarios, through
   ``warmup_multibook(staged=True)`` and 3 warm staged calls, with the
   checks of phase 4 (FD deltas also on the largest basis, breakeven and
   clamped-coupon OIS quotes), each region's time (P split into K1 and
   the clamp epilogue), the staged outputs against ``make_multibook_fn``,
   and the clamp PV epilogue and clamp quad form timed at its shapes
   (CUDA events, and the device time of their kernels in one
   torch.profiler trace);
8. each kernel against its plain torch twin on the card, at the shapes
   each path's main function gives it (K2 at that function's scenario
   chunk), with both times (CUDA events, median), K1's table
   build time and row reuse, K1's yardstick (one cuSPARSE SpMM of the
   trade x column CSR by the value table; the port never calls it), and
   each kernel's bound (bytes over HBM rate or flops over peak f64 rate,
   from that path's tables);
9. one bound line per kernel with the card line, the kernels' JSON line
   (time, plain, library, bound, share of bound, launches and launches
   per call on the main path), the card line, and the final JSON line.

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
import warnings


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


def _device_ms(f):
    """(ms, kernels) of one ``f()`` call on the device: the summed times
    of the kernels a torch.profiler trace records, after one warm-up run.
    Unlike ``_cuda_ms`` it leaves out the gaps in which the device waits
    for the host's launches. (None, 0) when the trace holds no kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    f()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        f()
        torch.cuda.synchronize()
    ks = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not ks:
        return None, 0
    return sum(e.time_range.elapsed_us() for e in ks) / 1e3, len(ks)


def _fmt_ms(ms) -> str:
    return "not measured (no kernel in the trace)" if ms is None \
        else f"{ms:.3f} ms"


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
    info = dict(_launches(), calls=1 + n_warm, cold_ms=cold_ms,
                warm_ms=warm,
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
    import torch
    N = mb.basket.n_quotes
    print(f"{name}: {len(mb.basket.specs)} curves built with refit gates "
          f"in {t_model * 1e3:.1f} ms; {n_base} trades compiled and tiled "
          f"to {mb.n_trades} in {t_compile * 1e3:.1f} ms", flush=True)
    print(f"{name}: N={N} n_grid={mb.basket.n_grid} "
          f"unique_times={mb.unique_times.shape[0]} "
          f"T={mb.aggregate.trip_s.shape[0]} S={n_scen} col buckets "
          f"[R, L]={[list(cb.col_idx.shape) for cb in mb.cols]} (base "
          f"rows); chunk {fn.chunk(n_scen)}; {fn.book.quad.n_groups} trip "
          f"groups of k={torch.diff(fn.book.quad.rptr).tolist()}"
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
    info["chunk"] = fn.chunk(cfg.N_SCENARIOS)
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


def _run_staged(name, mb, shocks, device, n_warm, describe):
    """A staged path: launch counts from 0, ``warmup_multibook`` as the
    cold call, ``n_warm`` warm calls; ``describe(fn)`` prints the shape
    lines. Returns (fn, out, info)."""
    import torch

    from adrates_torch.parallel.multibook import warmup_multibook
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    fn, cold_ms = _timed(lambda: warmup_multibook(mb, shocks.shape[0],
                                                  device, staged=True))
    describe(fn)
    out, info = _drive(f"{name} staged", fn, mb.basket.quotes0, shocks,
                       n_warm, cold=(None, cold_ms))
    info["chunk"] = fn.chunk(shocks.shape[0])
    return fn, out, info


def _time_regions(fn, q0, shocks, device):
    """Each region's host-clock ms on the first warm chunk; returns (ms
    by region, region A's output)."""
    import torch
    sh = torch.as_tensor(shocks[:fn.chunk(shocks.shape[0])], device=device)
    q = torch.as_tensor(q0, device=device)[None, :] + sh
    r = fn.regions
    a, ms_a = _timed(lambda: r["A"](q))
    t1, ms_b = _timed(lambda: r["B"](a["J"], a["dfs"]))
    (h2x, v_of), ms_c1 = _timed(lambda: r["C1"](q, a["g"], a["carry"]))
    h2o, ms_c2 = _timed(lambda: r["C2"](q, a["g"], v_of))
    _, ms_d = _timed(lambda: r["D"](t1, h2x, h2o))
    _, ms_p = _timed(lambda: r["P"](a["dfs"]))
    return dict(A=ms_a, B=ms_b, C1=ms_c1, C2=ms_c2, D=ms_d, P=ms_p), a


def _print_regions(name, chunk, regions, note=""):
    print(f"{name} regions (chunk {chunk}{note}): "
          f"{ {k: round(v, 2) for k, v in regions.items()} } ms", flush=True)


def _top_quote(mb, delta0, kind):
    """The quote of the largest |delta| among the curves of ``kind``."""
    specs = [sp for sp in mb.basket.specs if sp.kind == kind]
    lo = min(sp.offset for sp in specs)
    hi = max(sp.offset + sp.n_quotes for sp in specs)
    return lo + int(delta0[lo:hi].abs().argmax())


def _check_staged_vs_mono(name, out, mono, q0, shocks):
    ref = mono(q0, shocks)
    for k in ("pvs", "delta", "gamma"):
        _check(f"{name} staged vs make_multibook_fn {k} (abs / max|ref|)",
               float((out[k] - ref[k]).abs().max() / ref[k].abs().max()),
               1e-10)


def run_xccy_book(device, n_warm: int = 3):
    """Phase 6: the OIS + XCCY book through the staged regions."""
    import numpy as np

    from adrates_torch.examples import flagship_ois_xccy as cfg
    from adrates_torch.parallel.multibook import make_multibook_fn

    rng = np.random.default_rng(cfg.SEED)
    t0 = time.perf_counter()
    model = cfg.build_model()
    t_model = time.perf_counter() - t0
    t0 = time.perf_counter()
    base, coll = cfg.build_trades(model, rng)
    scale = rng.uniform(0.5, 2.0, cfg.N_TRADES // len(base))
    mb = _compile(model, base, scale, collateral_types=coll)
    t_compile = time.perf_counter() - t0
    shocks = rng.normal(0.0, 1e-3, (cfg.N_SCENARIOS, mb.basket.n_quotes))
    q0 = mb.basket.quotes0

    fn, out, info = _run_staged(
        "xccy", mb, shocks, device, n_warm,
        lambda fn: _describe("xccy", mb, fn, cfg.N_SCENARIOS, t_model,
                             t_compile, len(base)))
    info["regions_ms"], a = _time_regions(fn, q0, shocks, device)
    _print_regions("xccy", a["dfs"].shape[0], info["regions_ms"])
    del a

    mono = make_multibook_fn(mb, device=device)
    check_outputs("xccy", out, mono, q0, shocks, mb.n_trades,
                  fd_extra=(_top_quote(mb, out["delta"][0], "xccy"),))
    _check_staged_vs_mono("xccy", out, mono, q0, shocks)
    return mono, mb, q0, shocks, info


def run_flagship_v5(device, n_warm: int = 3):
    """Phase 7: the flagship_v5 book through the staged regions."""
    import numpy as np
    import torch
    from torch.func import grad, vmap

    from adrates_torch.examples import flagship_v5 as cfg
    from adrates_torch.ops import kernels
    from adrates_torch.parallel import multibook as tmb

    rng = np.random.default_rng(cfg.SEED)
    t0 = time.perf_counter()
    model = cfg.build_model()
    t_model = time.perf_counter() - t0
    t0 = time.perf_counter()
    with warnings.catch_warnings():        # CHF has no trades
        warnings.simplefilter("ignore", UserWarning)
        mb, shocks = cfg.build_book(model, rng)
    t_compile = time.perf_counter() - t0
    S = cfg.N_SCENARIOS
    q0 = mb.basket.quotes0
    stages = [(st.kind, len(st.ids)) for st in mb.basket.stages]
    if stages != [("ois", 7), ("xccy", 3), ("infl", 2)]:
        raise AssertionError(f"flagship_v5 stages {stages}")
    if mb.clamp is None:
        raise AssertionError("flagship_v5 has no clamp slots")

    def describe(fn):
        _describe("flagship_v5", mb, fn, S, t_model, t_compile,
                  mb.tile.base_trades)
        print(f"flagship_v5: {mb.clamp.w.shape[0]} clamp slots in the base "
              f"book ({fn.book.clamp.w.shape[0]} tiled)", flush=True)

    fn, out, info = _run_staged("flagship_v5", mb, shocks, device, n_warm,
                                describe)

    # per-region times on one warm chunk, P split into value table + K1
    # and the clamp epilogue
    book = fn.book
    regions, a = _time_regions(fn, q0, shocks, device)
    pv1, regions["P_K1"] = _timed(lambda: kernels.pvs_sweep(
        tmb.value_table(a["dfs"], book.aggregate), book.sweep))
    _, regions["P_clamp"] = _timed(lambda: tmb.clamp_epilogue(
        pv1, a["dfs"], book.clamp))
    info["regions_ms"] = regions
    _print_regions("flagship_v5", a["dfs"].shape[0], regions,
                   "; P_K1 = value table + K1, P_clamp = clamp epilogue")

    # the clamp epilogue and the clamp quad form at this path's shapes
    # (torch ops, no kernel records): CUDA events around a call, which
    # hold the host's launch gaps, and the device time of its kernels
    mono = tmb.make_multibook_fn(mb, device=device)
    dfs_all = mono.dfs_only(q0, shocks)
    pv_all = kernels.pvs_sweep(tmb.value_table(dfs_all, book.aggregate),
                               book.sweep)
    J, dfs_c = a["J"], a["dfs"]
    clamp_terms = dict(
        clamp_epilogue=lambda: tmb.clamp_epilogue(pv_all, dfs_all,
                                                  book.clamp),
        clamp_quad_form=lambda: vmap(lambda j, d: tmb._clamp_quad_form(
            j, d, book.clamp_agg))(J, dfs_c))
    for key, f in clamp_terms.items():
        info[f"{key}_ms"] = _cuda_ms(f)
        info[f"{key}_device_ms"], info[f"{key}_kernels"] = _device_ms(f)
    print(f"flagship_v5 clamp PV epilogue (pvs {list(pv_all.shape)}, "
          f"{book.clamp.w.shape[0]} slots): {info['clamp_epilogue_ms']:.3f} "
          f"ms by events, device "
          f"{_fmt_ms(info['clamp_epilogue_device_ms'])} in "
          f"{info['clamp_epilogue_kernels']} kernels; clamp quad form under "
          f"vmap (J {list(J.shape)}, {book.clamp_agg.w.shape[0]} aggregate "
          f"slots): {info['clamp_quad_form_ms']:.3f} ms by events, device "
          f"{_fmt_ms(info['clamp_quad_form_device_ms'])} in "
          f"{info['clamp_quad_form_kernels']} kernels", flush=True)
    del a, pv1, pv_all, dfs_all, J, dfs_c

    # FD probes: the largest basis and breakeven quotes, and the GBP/USD
    # OIS quote that moves the clamped coupons most
    extra = [_top_quote(mb, out["delta"][0], k) for k in ("xccy", "infl")]
    dfs0, J0 = mono.jacobians(q0, shocks[:1])
    g_cl = grad(lambda d: tmb._clamp_pvs(d, book.clamp_agg).sum())(dfs0[0])
    d_cl = (J0[0] @ g_cl).abs()
    ois = torch.zeros_like(d_cl, dtype=torch.bool)
    for name in ("GBP_OIS_SONIA", "USD_OIS_SOFR"):
        ois[mb.basket.quote_slice(name)] = True
    extra.append(int(torch.where(ois, d_cl, 0.0).argmax()))
    del dfs0, J0
    print(f"flagship_v5 FD probes: basis {extra[0]}, breakeven {extra[1]}, "
          f"clamped-coupon OIS {extra[2]}", flush=True)
    check_outputs("flagship_v5", out, mono, q0, shocks, mb.n_trades,
                  fd_extra=tuple(extra))
    _check_staged_vs_mono("flagship_v5", out, mono, q0, shocks)
    del out
    torch.cuda.empty_cache()
    return mono, mb, q0, shocks, info


# Peak rates of one H100 SXM at its 700 W limit (NVIDIA's data sheet):
# HBM3 bytes/s, f64 FMA on the CUDA cores and on the tensor cores.
HBM_BPS = 3.35e12
FP64_FLOPS = 34e12
FP64_TC_FLOPS = 67e12


def _bound(nbytes: float, flops: float, peak_flops: float):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    flops over the peak rate."""
    t_b, t_f = nbytes / HBM_BPS * 1e3, flops / peak_flops * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def compare_kernels(path, fn, mb, q0, shocks, device, chunk):
    """Phase 8: each kernel against its plain twin at one path's shapes,
    with its bound and yardstick; returns the kernels' records (without
    launch counts). ``fn`` is a make_multibook_fn of the book (its grids,
    jacobians and tables); ``chunk`` is the scenario chunk of the path's
    main function, at which that function launches K2."""
    import numpy as np
    import torch

    from adrates_torch.ops import kernels
    from adrates_torch.parallel import multibook as tmb

    book = fn.book
    dfs = fn.dfs_only(q0, shocks)
    S = dfs.shape[0]
    vT = tmb.value_table(dfs, book.aggregate)
    M = vT.shape[0]
    tab = book.sweep
    B = tab.n_trades
    inp = tmb.book_inputs(mb)
    cols = tmb.expanded_cols(inp, device)
    padded = sum(int(c.col_idx.numel()) for c in cols)
    live = sum(int((c.w != 0).sum()) for c in cols)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tmb.sweep_tables_from_cols(cols, B, M)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    del cols
    nnz, n_rows = int(tab.slot_w.numel()), int(tab.brow.numel())
    longest = int((tab.tptr[1:] - tab.tptr[:-1]).max())
    print(f"{path} K1 tables: built in {build_ms:.1f} ms; {padded} padded "
          f"slots, {live} live, {nnz} after merging; {n_rows} staged rows "
          f"in {tab.bptr.numel() - 1} blocks of {kernels.SWEEP_BLOCK} "
          f"trades "
          f"(reuse {nnz / max(n_rows, 1):.3f} slots per staged row); "
          f"longest trade {longest} slots", flush=True)
    ref = kernels.pvs_sweep_plain(vT, tab)
    got = kernels.pvs_sweep(vT, tab)
    err1 = float((got - ref).abs().max())
    _check(f"{path} K1 pvs_sweep vs plain (abs / max|ref|)",
           err1 / float(ref.abs().max()), 1e-12)
    ms1 = _cuda_ms(lambda: kernels.pvs_sweep(vT, tab))
    pms1 = _cuda_ms(lambda: kernels.pvs_sweep_plain(vT, tab))
    # yardstick: one cuSPARSE SpMM of the trade x column CSR by vT
    with warnings.catch_warnings():          # CSR support is "beta"
        warnings.simplefilter("ignore", UserWarning)
        csr = torch.sparse_csr_tensor(tab.tptr.long(), tab.slot_col(),
                                      tab.slot_w, size=(B, M))
    vTc = vT.contiguous()
    lib = torch.sparse.mm(csr, vTc)
    _check(f"{path} K1 cuSPARSE SpMM vs plain (abs / max|ref|)",
           float((lib.T - ref).abs().max() / ref.abs().max()), 1e-12)
    lms1 = _cuda_ms(lambda: torch.sparse.mm(csr, vTc))
    del lib, csr, vTc
    # the function's bytes: a plain trade x column CSR (trade pointer,
    # 4-byte column and 8-byte weight per slot), vT and out; the
    # kernel's own block row lists (bptr, brow) are not counted
    bytes1 = 4 * (B + 1) + 12 * nnz + 8 * M * S + 8 * S * B
    bound1, by1 = _bound(bytes1, 2.0 * nnz * S, FP64_FLOPS)
    print(f"{path} K1 pvs_sweep vT [M, S]={[M, S]} B={B}: kernel "
          f"{ms1:.3f} ms, plain {pms1:.3f} ms, cuSPARSE {lms1:.3f} ms; "
          f"bound {bound1 * 1e3:.1f} us ({by1}, {bytes1 / 1e6:.1f} MB)",
          flush=True)
    del vT, ref, got

    dfs_c, J = fn.jacobians(q0, shocks[:chunk])
    J = J.contiguous()
    qt = book.quad
    ref = kernels.gamma_quad_form_grouped_plain(J, dfs_c, qt)
    got = kernels.gamma_quad_form_grouped(J, dfs_c, qt)
    err2 = float((got - ref).abs().max())
    _check(f"{path} K2 gamma_quad_form_grouped vs plain (abs / max|ref|)",
           err2 / float(ref.abs().max()), 1e-12)
    ms2 = _cuda_ms(lambda: kernels.gamma_quad_form_grouped(J, dfs_c, qt))
    pms2 = _cuda_ms(lambda: kernels.gamma_quad_form_grouped_plain(
        J, dfs_c, qt))
    Sc, N, n_grid = J.shape
    tptr, rptr = qt.tptr.cpu().numpy(), qt.rptr.cpu().numpy()
    cols_all = [np.concatenate([x.cpu().numpy()[tptr[g]:tptr[g + 1]]
                                for x in (qt.s_idx, qt.e_idx, qt.p_idx)])
                for g in range(qt.n_groups)]
    rows = qt.rows.cpu().numpy()
    need_j = np.unique(np.concatenate(
        [(rows[rptr[g]:rptr[g + 1], None].astype(np.int64) * n_grid
          + np.unique(cols_all[g])[None, :]).ravel()
         for g in range(qt.n_groups)])).size
    need_d = np.unique(np.concatenate(cols_all)).size
    k = np.diff(rptr).astype(np.int64)
    T = np.diff(tptr).astype(np.int64)
    it = qt.items.cpu().numpy().astype(np.int64)
    gathered = 3 * int(((it[:, 2] + it[:, 4]) * T[it[:, 0]]).sum())
    bytes2 = 8 * Sc * (need_j + need_d + N * N)
    bound2, by2 = _bound(bytes2, 4.0 * float((k * k * T).sum()) * Sc,
                         FP64_TC_FLOPS)
    print(f"{path} K2 gamma_quad_form_grouped J={list(J.shape)}: kernel "
          f"{ms2:.3f} ms, plain {pms2:.3f} ms; J values needed {need_j} "
          f"per scenario ({8 * Sc * need_j / 1e6:.1f} MB per call), "
          f"gathered {gathered} ({8 * Sc * gathered / 1e6:.1f} MB); bound "
          f"{bound2 * 1e3:.1f} us ({by2}, {bytes2 / 1e6:.1f} MB)",
          flush=True)
    del J, ref, got
    torch.cuda.empty_cache()
    return [
        dict(name="pvs_sweep", path=path, route="cuda",
             source="adrates_torch/csrc/pvs_sweep.cu",
             replaces="adrates_tpu/parallel/multibook.py:1782",
             max_abs_err=err1, ms=ms1, plain_ms=pms1, library_ms=lms1,
             library="torch.sparse.mm (cuSPARSE SpMM) of the [B, M] "
                     "trade x column CSR by vT",
             bound_ms=bound1, bound_by=by1, share_of_bound=bound1 / ms1,
             tables_build_ms=build_ms, reuse=nnz / max(n_rows, 1)),
        dict(name="gamma_quad_form_grouped", path=path, route="cuda",
             source="adrates_torch/csrc/gamma_quad_form.cu",
             replaces="adrates_tpu/parallel/multibook.py:1660",
             max_abs_err=err2, ms=ms2, plain_ms=pms2, library_ms=None,
             library="none: no single PyTorch call computes a gather, a "
                     "rank-2 quad form and a scatter into G",
             bound_ms=bound2, bound_by=by2, share_of_bound=bound2 / ms2,
             j_needed_mb=8 * Sc * need_j / 1e6,
             j_gathered_mb=8 * Sc * gathered / 1e6),
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

    # ---- phases 3-7 ------------------------------------------------------
    fn_o, mb_o, q_o, sh_o, info_o, info_g = run_ois_slice(device)
    fn_x, mb_x, q_x, sh_x, info_x = run_xccy_book(device)
    fn_f, mb_f, q_f, sh_f, info_f = run_flagship_v5(device)
    for path, info in (("ois_slice", info_o), ("ois_slice_generic", info_g),
                       ("ois_xccy_book", info_x), ("flagship_v5", info_f)):
        for name in ("pvs_sweep", "gamma_quad_form_grouped"):
            if info[name] <= 0:
                raise AssertionError(f"{name} was not launched on the "
                                     f"{path} path")

    # ---- phase 8 -------------------------------------------------------
    infos = dict(ois_slice=info_o, ois_xccy_book=info_x, flagship_v5=info_f)
    records = []
    for path, args in (("ois_slice", (fn_o, mb_o, q_o, sh_o)),
                       ("ois_xccy_book", (fn_x, mb_x, q_x, sh_x)),
                       ("flagship_v5", (fn_f, mb_f, q_f, sh_f))):
        records += compare_kernels(path, *args, device,
                                   chunk=infos[path]["chunk"])
    for r in records:
        info = infos[r["path"]]
        r["launches"] = info[r["name"]]
        r["launches_per_call"] = info[r["name"]] / info["calls"]
    torch.cuda.synchronize()
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)

    # ---- phase 9 -------------------------------------------------------
    card = _card_line()
    for r in records:
        print(f"bound {r['path']} {r['name']}: {r['ms']:.4f} ms against "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), share "
              f"{r['share_of_bound']:.3f}, {r['launches_per_call']:g} "
              f"launches per call; card {card}")
    print(json.dumps({"kernels": records}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
