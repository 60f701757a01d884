#!/usr/bin/env python3
"""Smoke run of the adrates_torch book-risk paths and single-trade engine on
one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` (on PATH or under $CUDA_HOME) and
``nvidia-smi``; it builds the CUDA kernels from ``adrates_torch/csrc`` on
first use. Phases:

1. environment: the card's name and power limit, torch/CUDA/nvcc versions;
2. build: compile and load the kernels (K1 pvs_sweep, K2 gamma quad form,
   K3 per-trade quad form, K4 pv01_solve and K5 pv01_solve_t, the OIS
   bootstrap's chain solve and its transpose, K6 fitted_eval (the fitted
   schemes' evaluation at static queries, DFs to DFs), its tangent mode
   fitted_eval_jvp and its linear core fitted_rows, K7 fitted_rows_t the
   core's transpose, K8-K11 the XCCY stage's jacobian and Hessian in dual and
   hyper-dual arithmetic, K12 its node DFs' tangents and second derivatives
   for the per-trade tensors, K13 ois_stage_jvp and K14 ois_stage_hess the
   OIS stage's quote jacobian and Hessian, a block a (scenario, member));
3. OIS slice: the flagship OIS book (7 curves, N = 144 quotes, 720 OIS
   tiled to 100,080 trades, 100 scenarios) through ``make_multibook_fn``
   on the structured risk split: one cold call, then 3 warm calls, the
   device ops and ms of one warm call; the route of every OIS stage (K13 /
   K14 or torch.func) is printed for every book, and on this path, phase
   6's and phase 7's staged and monolithic calls K13 and K14 are gated as
   launched and K4 / K5 as not;
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
   the route of every XCCY stage (K8-K11 or torch.func, decided when the
   book compiles) is printed for every book, and K8-K11's launches a
   call on this path and phase 7's (gated: all four launched) and on
   phase 7b's ladders (K8, K9);
7. flagship_v5, the whole book of the repository's ``bench.py``: 12
   curves (7 OIS + 3 XCCY + 2 inflation, N = 184), 1,004 trades of every
   kind (FRNs with cap/floor clamp slots, bonds, ZCIS and YoY, fix-float
   and fix-fix XCCY) tiled to 100,400, 100 scenarios, through
   ``warmup_multibook(staged=True)`` and 3 warm staged calls, with the
   checks of phase 4 (FD deltas also on the largest basis, breakeven and
   clamped-coupon OIS quotes), each region's time (P split into K1 and
   the clamp epilogue), the device ops and ms of regions A, C1 and C2 on
   the first chunk, the staged outputs against ``make_multibook_fn``,
   and the clamp PV epilogue and clamp quad form timed at its shapes
   (CUDA events, and the device time of their kernels in one
   torch.profiler trace);
7b. per-trade risk on phase 7's book at ``bench.py``'s shapes: every
   trade's delta ladder [100,400 x 184] (K1 trade-major, one launch a
   call), the dense gammas of 256
   trades from ``default_rng(7)`` with a capped FRN and an XCCY trade
   among them (K3 at k = 184) and every trade's own-block gamma (K3 over
   the signature groups), each cold + 3 warm with its launch counts, its
   J pass, the blocks builder's time, the groups and k_max, peak memory;
   checks: the ladders sum to the staged book delta and the blocks to
   its gamma at zero shock (1e-9 rel), the FRN's and the XCCY trade's
   ladders against a central FD of their PVs (1e-5 rel), each dense
   gamma symmetric and equal to its block (1e-10 rel); each XCCY stage's
   per-trade route (gated: on K12, K9 and K11, split at the node DFs),
   K12 / K9 / K11 launches a call on the gammas and the blocks (gated:
   launched), the device ops and device ms of one warm call of each, and
   K12's, K9's and K11's arguments in one gammas call for phase 8;
7c. the single-trade engine on phase 7's model (K4 / K5 its only
   kernels):
   the README quick start (VALUE, DELTA, GAMMA through ``position(model)``
   with no device, so on the card); ``bench.py``'s config 2 on
   flagship_v5's 32-pillar GBP curve (a 10Y OIS: VALUE + DELTA + GAMMA
   cold and 20 warm, SPEED cold and 5 warm, on the host clock; the device
   ops and device time of one request in a torch.profiler trace; the
   same request on an engine asked for the CPU, held to the card's at
   1e-12; the 10Y delta against a central FD of VALUE on models rebuilt
   with that quote +-1 bp, 1e-5) and config 1 (100 warm bootstraps);
   one live base trade of every route (natural and USD-collateral OIS,
   XCCY basis, fix-float and fix-fix, ZCIS, YoY, bond, capped FRN):
   finite outputs, symmetric gamma blocks (1e-10), PV equal to the
   trade's host ``value`` (abs 1e-6 or rel 1e-12); the kernel launch
   counts of that path (none); the engine against the book of the GBP
   OIS and ZCIS (PVs at 1e-10, K1's per-trade ladders x 1e-4 at rtol
   1e-9 / 1e-8); a Portfolio per valuation currency equal to the sum of
   its trades' PVs; the forward-mode rule of ``ops/linear_solve`` on this
   torch (one level counted under jacfwd(jacrev), two under
   jacfwd(jacfwd), where the bootstrap raises); an ``engine`` JSON line
   before the kernels line;
7d. flagship_v5 on the fitted schemes (``flagship_v5.SPLINE_SCHEMES``:
   GBP PCHIP_LOG_DISCOUNT, USD PCHIP_ZERO_RATES, EUR
   NATCUBIC_LOG_DISCOUNT, JPY NATCUBIC_ZERO_RATES, AUD
   FINCUBIC_ZERO_RATES; CHF and CAD FLAT_FWD; the book, seed and draw
   order of phase 7): each spline member's pad count in its stage, the
   staged path cold + 3 warm with phase 7's gates (FD also on the largest
   GBP, USD and JPY quotes), per-region times, each region's device ops
   and device ms on the first chunk beside the parent's (``PERF.md``),
   and the device ops and device ms of one warm call (phase 7's beside
   them); the three XCCY stages' routes (gated: each on the kernels, its
   fitted parents through their query grids), K8-K11 launched on the
   staged path (gated) and their inputs captured at each stage's calls of
   the first chunk for phase 8; the generic split once (= structured); each spline curve's ``df_t`` against the book's
   grid row and the engine's PV against the book's on one live OIS of
   each spline curve and one basis swap of each XCCY curve (1e-10); the
   per-trade paths of phase 7b on this book (its XCCY stages, over
   fitted parents, keep the torch.func towers there: routes printed, K12
   gated as not launched); K6 / K7 launches a call on
   the staged, generic and per-trade paths (gated: every path launches
   K6's evaluation, and K7 where it runs reverse mode), the 256 gammas'
   warm wall and device ops
   beside phase 7b's on FLAT_FWD; K6's and K7's inputs captured from one
   staged chunk's regions A, C1 and C2 and the 256 gammas for phase 8
   (K6's evaluation and tangent mode with their inputs, K7's shapes);
   K1, K2 and K3 against their
   twins on its inputs (1e-12, gates, not kernel records); config 2 on
   the PCHIP GBP curve (cold + 20 warm, device ops, cuda = cpu) and one
   bond's duration and g-spread on the host; the farthest reach past the
   last knot, in last intervals, of every static fitted plan the phase
   built (the book's, the XCCY stages' query grids, the engine's); a
   ``splines`` JSON line before the kernels line;
7e. the host API and the single-curve book (K1; no new kernel): the
   port's quick start (``adrates_torch.examples.quickstart.main()``, on the
   card; the +100 bp P&L beside its first- and second-order estimates,
   the second closer); ``bench.py``'s config-2 DELTA on flagship_v5's
   GBP_OIS_SONIA against central FDs of VALUE on ``model.scenario`` +-1
   bp at its three largest buckets (1e-5 of the largest: the swap is at
   par, its other buckets ~0); ``scenario_grid`` of 100
   N(0, 0.1) % shocks cold + 3 warm with device ops and ms, rows 0, 49
   and 99 equal to ``model.scenario``'s DFs (1e-12); phase 7's model
   through ``to_json`` / ``from_json`` (every curve's DFs and the config-2
   PV bit for bit) and ``Model.fx`` on routed pairs (1e-15) and one with
   no route (raises); the quick start's 20 OIS tiled x5,000 with per-copy
   coupon and notional scales (100,000 trades) under 100 N(0, 1e-3)
   shocks through ``make_book_fn`` (tables and kernel build apart, cold +
   3 warm, device ops and ms, busy share, K1 launches per call, peak
   memory; gates: finite, sum of trade PVs = ``aggregate_total_pv``
   1e-9, delta vs FD 1e-5, gamma symmetric 1e-10, K1 = twin 1e-12, the
   base book's delta and gamma = ``make_multibook_fn``'s on the same
   trades 1e-9); 1,000 OIS of 1Y-50Y in 4 pad buckets each tiled x100
   through ``make_bucketed_book_fn`` (merged aggregate = the monolithic
   book's, PVs = ``make_book_fn``'s permuted by ``order`` 1e-12, delta and
   gamma equal); book SPEED at N = 64 (GBP and USD OIS curves, their 240
   flagship OIS) cold + 3 warm (symmetric, = FD of the gamma, the
   184-quote book refused); a ``hostapi`` JSON line before the kernels
   line;
7g. the OIS host analytics and the print tables (K4 / K5 only), after 7e
   and before 7f-c: ``bench.py``'s config-2 OIS on phase 7's flagship_v5
   GBP_OIS_SONIA, its ``pv01``, ``ir01`` and ``swap_rate`` cold + 20 warm
   on the host clock beside the engine's DELTA ladder sum (not gated);
   gates: the OIS struck at c* = 100 |swap_rate| prices on the card to
   |VALUE| <= 1e-8 x notional, VALUE(c + 1bp) - VALUE(c) on the card
   equals pv01 x notional x 1e-6 (1e-9 rel), and the OIS's
   ``print_payments`` / ``print_fixed_leg_pv`` / ``print_float_leg_pv``
   and a live basis swap's ``print_payments`` / ``print_valuation``
   print one table row per payment; none of K1-K3 launched; an
   ``analytics`` JSON line before the kernels line;
7f. the sharded paths (``adrates_torch.parallel.distributed``) and the
   f32 ladders; (c) runs before phase 8 and (a), (b) after it, so phase
   8 times its kernels with no process group made and no rank spawned.
   (a) World 1 on NCCL in this process
   (``init_distributed`` on a free localhost port, which makes a group
   of one rank and returns False, as the JAX function does for one
   process; ``book_mesh``): every
   sharded function cold + 3 warm with its K1 / K3 launches a call
   (``make_sharded_multibook_fn`` on phase 7's flagship_v5 at S = 100,
   the sharded ladders, 256 gammas and blocks, ``make_sharded_book_fn``
   and ``make_pershard_aggregate_fn`` on phase 7e's 100,000-trade book)
   beside the single-device warm times of phases 7, 7b and 7e; gates:
   the totals against phase 7's at 1e-12 rel, delta and gamma at 1e-10
   x max|ref|, the gathered ladders (dead rows exactly zero), gammas and
   blocks against phase 7b's fns at 1e-12 x max|ref|, the book fns
   against ``make_book_fn``'s at 1e-9. (b) World 3 on the one card over
   gloo: three spawned ranks (``distributed.run_ranks``, joined with a
   timeout; a failed rank fails the phase), each building flagship_v5
   at S = 10 (100,400 trades padded to 100,401) and the single-curve
   book at 5,001 copies, each running every sharded function cold and
   warm with its K1 once a call on its own trades; rank 0 gathers the
   shards and holds them to its own single-device results at (a)'s
   tolerances. (c) The f32 ladders [100,400 x 184] cold + 3 warm, f32,
   against phase 7b's f64 ladders at rtol 1e-4, atol 3e-6 x max|f64|.
   A ``sharded`` JSON line before the kernels line (world sizes,
   backends, times, ``count``, and the note that world 3's times are
   three processes sharing one card, not a scaling figure);
8. each kernel against its plain torch twin on the card, at the shapes
   each path's main function gives it (K2 at that function's scenario
   chunk; K1's trade-major kernel at the ladders' Jv [n_grid + T, N] in
   f64 and in f32 (against its f32 twin at 1e-5 x max|ref|, with a
   cuSPARSE f32 SpMM yardstick), each with the whole contraction as the
   ladder path runs it (``fn.contract``: K1 and the clamp rows) and
   whether it equals the scenario-major kernel's sums transposed, bit
   for bit; K3 on both per-trade paths; K1 also at phase 7e's
   single-curve book; K3's blocks
   also bit for bit symmetric; K4 and K5 at the largest call of one
   config-2 engine request and of one staged call of phase 7d's spline
   cell (regions A and C2's torch.func towers over its OIS stage, whose
   fitted members keep them), K4 bit for bit equal to its plain
   K-sweep and K5 at 1e-14 x max|ref|, with one batched
   ``torch.linalg.solve_triangular`` on the dense (I - A) as the
   yardstick and the kernel's time on one row a plan, its chain of P
   dependent steps); K6's evaluation and its tangent mode at the spline
   book's largest calls of regions A (the OIS stage's five fitted
   members) and C1 (an XCCY stage's legs) and of the 256 gammas, on the
   captured inputs, against their plain versions at 1e-12 x max|ref|
   and their own second launch bit for bit (gated), with their tiles,
   registers and local bytes and no yardstick (no PyTorch call computes
   the evaluation); K6's linear core at the 256 gammas' largest call
   (the one path that launches it) and, off the path, at A's and C1's
   tangent calls' rows, and K7 at its largest calls of regions C2 and C1
   and of the 256 gammas, on seeded inputs, against their twins and their second launch
   the same way, with one torch.bmm of the inputs by the dense operators
   the plan implies as the core's yardstick);
   K8-K11 at their calls of one flagship_v5 staged chunk, and at each of
   the spline cell's three XCCY stages (their fitted parents' query
   grids; phase 7d's capture, on the main path) (captured; K9
   and K11 on legs that do not telescope, ``xccy_stage.probe_tables``,
   and seeded domestic tangents) against their plain versions at 1e-12 x
   max|ref| of every output, the Hessians symmetric bit for bit, two
   launches equal bit for bit (gated), their registers, local bytes a
   thread and blocks an SM; K12 and K9 / K11 at phase 7b's captured
   per-trade call the same way (K12's outputs ds, Jn, Jfd, Hn, Hn equal to
   its mirror bit for bit; its two launches' device ms each, the pair
   launch's blocks and warps a block, each launch's registers, local
   bytes and blocks an SM; gated: no local memory, a block an SM at
   least), with no
   library yardstick (no PyTorch call computes a stage's jacobian or
   Hessian) and their bound from the operations the function needs,
   ``xccy_stage.needed_flops``, beside the kernel's own count, the
   smaller of the two where K9 / K11's collapse onto the domestic grid
   counts fewer); K13 and K14 at their calls of one flagship_v5 staged
   chunk and of one OIS slice chunk (captured) against their plain
   versions at 1e-12 x max|ref|, two launches equal bit for bit and no
   local memory (gated), their registers, shared memory and blocks an SM,
   no library yardstick, their bound from ``ois_stage.needed_flops`` /
   ``needed_bytes``),
   each timed
   over 30 calls by CUDA events around the call (``ms``, which holds the
   wrapper's host work) and by the device time of its kernels in a
   torch.profiler trace (``device_ms``), the twin's time, K1's table
   build time and row reuse, a yardstick the port never calls (K1: one
   cuSPARSE SpMM of the trade x column CSR; K2 and K3: one torch.bmm of
   pre-gathered padded [w X; Y] and [Y; w X] operands, K2's over
   (scenario, group), checked against the twin), and each kernel's bound
   (bytes over HBM rate or flops over peak f64 rate, from that path's
   tables). The device time comes from the kernels launched inside each
   call's ``record_function`` window (placed by their launch's
   correlation id; the calls with the usual kernel count);
   a gate holds every device time, the yardsticks' and the ladders'
   contractions' too, to at most 1.1 times its event window;
9. one bound line per kernel with the card line, a ``pertrade`` JSON line
   (phase 7b's gammas and blocks: device ops and device ms of one warm
   call, the warm walls, K12 / K9 / K11 launches), the kernels' JSON line
   (both times, plain, library, bound, share of bound by device time and
   by events, launches and launches per call on the main path), the card
   line, and the final JSON line.

Each path's kernel launch counts are set to 0 just before it runs and
read just after (or read before and after it). Every path that
bootstraps an OIS curve on the card (phases 3-7g) reports its K4 / K5 and
K13 / K14 launches a call and fails unless K4 or K13 launched, and K5 or
K14 too where the path differentiates in reverse mode (the spline cell:
K4 and K5 themselves). Any failed check raises, so the script exits non-zero
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


def _stats(times) -> dict:
    return dict(median=statistics.median(times), min=min(times),
                max=max(times), reps=len(times))


def _cuda_stats(f, reps: int = 30) -> dict:
    """Event-window milliseconds of ``f()`` (CUDA events around each of
    ``reps`` calls, after one warm-up call): median, min, max. A window
    holds the host work of the call between its two events."""
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
    return _stats(times)


def _cuda_ms(f, reps: int = 30) -> float:
    """Median event-window milliseconds of ``f()`` (``_cuda_stats``)."""
    return _cuda_stats(f, reps)["median"]


def _device_stats(f, reps: int = 30):
    """Device milliseconds per ``f()`` call from one torch.profiler trace
    of ``reps`` synchronized calls (after one warm-up call), each call
    inside a ``record_function`` window that ends after its synchronize.
    A device event (kernel, copy, fill) belongs to the window that holds
    the host call that launched it (the runtime API event of the same
    correlation id, on the host's clock), or, where the trace holds no
    such host event, the window that holds its own midpoint; one outside
    every window is not counted. The calls that hold the most common
    number of device events (a trace can lose one) give the per-call
    sums: median, min, max, the events per call (``kernels``), the calls
    counted (``calls``), the share of events placed by their launch
    (``by_launch``) and each kernel's median device ms a call by its name
    (``by_name``, the name up to its argument list, without namespaces).
    Unlike the event window it leaves out the host's time before and
    between launches. A trace whose windows hold no
    device event (a trace on the card can come back empty) is taken
    again, up to three times; None if none holds one."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    f()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(reps):
                with record_function(f"_smoke_call_{i}"):
                    f()
                    torch.cuda.synchronize()
        events = prof.events()
        wins = sorted((e.time_range.start, e.time_range.end) for e in events
                      if e.device_type == DeviceType.CPU
                      and e.name.startswith("_smoke_call_"))
        # the host's CUDA API calls (cudaLaunchKernel, cuLaunchKernel,
        # cudaMemsetAsync, ...) by correlation id
        launch = {e.id: (e.time_range.start + e.time_range.end) / 2
                  for e in events if e.device_type == DeviceType.CPU
                  and e.name.startswith("cu")}
        per_call = [[] for _ in wins]
        names = [[] for _ in wins]
        placed = total = 0
        for e in events:
            if e.device_type != DeviceType.CUDA \
                    or e.name.startswith("_smoke_call_"):
                continue                   # host events, GPU annotations
            at = launch.get(e.id)
            total += 1
            placed += at is not None
            if at is None:
                at = (e.time_range.start + e.time_range.end) / 2
            for k, (a, b) in enumerate(wins):
                if a <= at <= b:
                    per_call[k].append(e.time_range.elapsed_us())
                    nm = e.name.replace("(anonymous namespace)::", "")
                    names[k].append(nm.split("(")[0].split("::")[-1]
                                    .split(" ")[-1])
                    break
        counts = [len(c) for c in per_call if c]
        if counts:
            n = statistics.mode(counts)
            full = [k for k, c in enumerate(per_call) if len(c) == n]
            out = _stats([sum(per_call[k]) / 1e3 for k in full])
            by_name = {}
            for k in full:
                for nm, us in zip(names[k], per_call[k]):
                    by_name.setdefault(nm, {}).setdefault(k, 0.0)
                    by_name[nm][k] += us / 1e3
            out.update(kernels=n, calls=out.pop("reps"),
                       by_launch=placed / total,
                       by_name={nm: statistics.median(v.values())
                                for nm, v in by_name.items()})
            return out
    return None


def _request_device(f):
    """(device ops, their summed device ms) of one warm ``f()`` call in a
    torch.profiler trace of the card's activity alone (an engine request
    dispatches thousands of small ops; the host events of a full trace
    take tens of seconds to collect); (None, None) when the trace holds
    no device event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    f()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        f()
        torch.cuda.synchronize()
    ks = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not ks:
        return None, None
    return len(ks), sum(e.time_range.elapsed_us() for e in ks) / 1e3


def _timings(kernel, plain, library=None) -> dict:
    """A kernel record's times, 30 calls each: the kernel's event window
    (``ms``, median) and its device time (``device_ms``, median, with min
    and max), the plain twin's event window, and the yardstick's event
    window and device time (None without one); ``device_by_launch`` is
    the share of the kernel's device events placed in their windows by
    their launch (``_device_stats``)."""
    ms = _cuda_ms(kernel)
    dv = _device_stats(kernel)
    out = dict(ms=ms, device_ms=dv and dv["median"],
               device_ms_min=dv and dv["min"], device_ms_max=dv and dv["max"],
               device_by_launch=dv and dv["by_launch"],
               plain_ms=_cuda_ms(plain), library_ms=None,
               library_device_ms=None)
    if library is not None:
        lms = _cuda_ms(library)
        lv = _device_stats(library)
        out.update(library_ms=lms, library_device_ms=lv and lv["median"])
    return out


def _shares(bound_ms: float, tm: dict) -> dict:
    """Share of the bound by device time (None where the trace held no
    kernel) and by event window."""
    return dict(share_of_bound=tm["device_ms"] and bound_ms / tm["device_ms"],
                share_of_bound_events=bound_ms / tm["ms"])


def _fmt_tm(tm: dict) -> str:
    """A record's times as one phrase."""
    lib = "" if tm["library_ms"] is None else (
        f", yardstick {tm['library_ms']:.4f} ms (device "
        f"{_fmt_ms(tm['library_device_ms'])})")
    return (f"kernel {tm['ms']:.4f} ms by events, device "
            f"{_fmt_ms(tm['device_ms'])}, plain {tm['plain_ms']:.3f} ms"
            + lib)


def _fmt_ms(ms) -> str:
    return "not measured (no kernel in the trace)" if ms is None \
        else f"{ms:.4f} ms"


def _check(name: str, err: float, bound: float):
    print(f"check {name}: {err:.3e} (bound {bound:.1e})", flush=True)
    if not err <= bound:
        raise AssertionError(f"check {name} failed: {err!r} > {bound!r}")


# every kernel's wrapper, by its launch-count key
KERNELS = ("pvs_sweep", "gamma_quad_form_grouped", "pertrade_quad_form",
           "pv01_solve", "pv01_solve_t", "fitted_eval", "fitted_eval_jvp",
           "fitted_rows", "fitted_rows_t", "xccy_stage_jvp", "xccy_legs_jvp",
           "xccy_stage_hess", "xccy_legs_hess", "xccy_stage_node_hess",
           "ois_stage_jvp", "ois_stage_hess")
# K6's entries (the evaluation, its tangent mode, the linear map) and K7
FITTED = ("fitted_eval", "fitted_eval_jvp", "fitted_rows", "fitted_rows_t")
XCCY = ("xccy_stage_jvp", "xccy_legs_jvp", "xccy_stage_hess",
        "xccy_legs_hess")
# the kernels of the per-trade tensors split at an XCCY stage's node DFs:
# K12, then K9 / K11 (their legs' PVs, gradients and Hessians)
NODE = ("xccy_stage_node_hess", "xccy_legs_jvp", "xccy_legs_hess")
# the OIS stage's kernels: K13 (region A's pass) and K14 (term2_ois)
OIS = ("ois_stage_jvp", "ois_stage_hess")


def _reset_launches():
    from adrates_torch.ops import kernels
    for k in KERNELS:
        getattr(kernels, k).launches = 0


def _launches() -> dict:
    from adrates_torch.ops import kernels
    return {k: getattr(kernels, k).launches for k in KERNELS}


def _launches_since(before: dict, calls: int) -> dict:
    """The launches made since ``before`` (a ``_launches()``), with
    ``calls``."""
    return dict({k: n - before[k] for k, n in _launches().items()},
                calls=calls)


def _solve_launches(path: str, info: dict, reverse: bool = True,
                    solves: bool = False):
    """Report K4 / K5 and K13 / K14 launches a call on one path that
    bootstraps on the card (``info``: its launch counts and ``calls``):
    the OIS bootstrap's kernels must have launched, K4 (the solve under a
    torch.func tower) or K13 (an OIS stage on its route), and K5 or K14
    too where the path differentiates in reverse mode; with ``solves``,
    K4 and K5 themselves (a path whose OIS stages keep the towers)."""
    k4, k5, n = info["pv01_solve"], info["pv01_solve_t"], info["calls"]
    k13, k14 = info["ois_stage_jvp"], info["ois_stage_hess"]
    print(f"{path}: K4 pv01_solve {k4 / n:g}, K5 pv01_solve_t {k5 / n:g}, "
          f"K13 ois_stage_jvp {k13 / n:g} and K14 ois_stage_hess "
          f"{k14 / n:g} launches a call ({n} calls)", flush=True)
    first, second = (k4, k5) if solves else (k4 + k13, k5 + k14)
    if first <= 0 or (reverse and second <= 0):
        raise AssertionError(f"{path}: the OIS bootstrap's kernels were not "
                             f"launched (K4 {k4}, K5 {k5}, K13 {k13}, K14 "
                             f"{k14})")


def _ois_routes(name, mb) -> dict:
    """Print and return each OIS and inflation stage's route (K13 / K14
    or torch.func), decided when the book compiled."""
    from adrates_torch.ops.ois_stage import ois_stage_routes
    from adrates_torch.parallel.multibook import book_inputs
    topo = book_inputs(mb).topology
    routes = {}
    for si, r in ({} if topo is None else ois_stage_routes(topo)).items():
        st = topo.stages[si]
        names = ", ".join(topo.specs[c].name for c in st.ids)
        routes[f"{st.key} ({names})"] = r
    print(f"{name}: OIS stage routes {routes}", flush=True)
    return routes


def _ois_launches(path: str, info: dict, routes: dict,
                  hess: bool = True) -> dict:
    """Gate a structured path whose OIS stages all take K13 / K14
    (``routes`` from ``_ois_routes``, inflation stages aside): K13 and,
    where the path takes term 2, K14 launched, and no K4 / K5 launch (the
    towers' solves) in the path's calls. Returns the launches a call."""
    n = info["calls"]
    per = {k: info[k] / n for k in OIS + ("pv01_solve", "pv01_solve_t")}
    print(f"{path}: K13 / K14 (ois_stage_jvp, ois_stage_hess) "
          f"{[per[k] for k in OIS]}, K4 / K5 "
          f"{[per['pv01_solve'], per['pv01_solve_t']]} launches a call "
          f"({n} calls)", flush=True)
    ois = [r for r in routes.values() if r != "torch.func: an inflation "
           "stage"]
    if not ois or any(r != "kernels" for r in ois):
        raise AssertionError(f"{path}: an OIS stage keeps the towers: "
                             f"{routes}")
    need = OIS if hess else OIS[:1]
    if any(info[k] <= 0 for k in need) or info["pv01_solve"] \
            or info["pv01_solve_t"]:
        raise AssertionError(f"{path}: K13 / K14 not launched or K4 / K5 "
                             f"launched ({ {k: info[k] for k in per} })")
    return per


def _capture_solves(run) -> dict:
    """Run ``run()`` with K4's and K5's wrappers watched: per kernel, the
    (rhs, denom, tables) of its call with the most rows, copied. The
    kernels' own launch counts are left as they were."""
    import torch

    from adrates_torch.ops import kernels
    keep = {}
    orig = {k: getattr(kernels, k) for k in ("pv01_solve", "pv01_solve_t")}

    def watched(name, f):
        def g(rhs, denom, tab):
            if name not in keep or rhs.shape[0] > keep[name][0].shape[0]:
                keep[name] = (rhs.clone(), denom.clone(), tab)
            return f(rhs, denom, tab)
        g.launches, g.calls = f.launches, f.calls
        return g

    for name, f in orig.items():
        setattr(kernels, name, watched(name, f))
    try:
        run()
        torch.cuda.synchronize()
    finally:
        for name, f in orig.items():
            setattr(kernels, name, f)
    if sorted(keep) != sorted(orig):
        raise AssertionError(f"the watched call ran {sorted(keep)} only")
    return keep


def _fitted_launches(path: str, info: dict, reverse: bool = True) -> dict:
    """Report K6's (its evaluation, tangent mode and linear map) and K7's
    launches a call on one path that evaluates a static fitted plan on the
    card (``info``: its launch counts and ``calls``): K6's evaluation
    must have launched, and K7 too where the path differentiates the rows
    in reverse mode. Returns them a call."""
    n = info["calls"]
    per = {k: info[k] / n for k in FITTED}
    print(f"{path}: K6 fitted_eval {per['fitted_eval']:g}, its tangent mode "
          f"fitted_eval_jvp {per['fitted_eval_jvp']:g}, its linear map "
          f"fitted_rows {per['fitted_rows']:g} and K7 fitted_rows_t "
          f"{per['fitted_rows_t']:g} launches a call ({n} calls)",
          flush=True)
    if info["fitted_eval"] <= 0 or (reverse and info["fitted_rows_t"] <= 0):
        raise AssertionError(f"{path}: the fitted-rows kernels were not "
                             f"launched ({ {k: info[k] for k in FITTED} })")
    return per


def _watch_fitted(steps, want) -> dict:
    """Run each ``(label, f)`` of ``steps`` in order with K6's and K7's
    wrappers watched: for each (label, kernel) of ``want``, its call with
    the largest output: (input shape, tables) for K6's linear map and K7
    (their records draw seeded inputs), (the shape [R, D, G, W_max] or
    [R, G, W_max] of the output, the inputs copied and the plan) for K6's
    evaluation and tangent mode. The kernels' own launch counts are left
    as they were."""
    import torch

    from adrates_torch.ops import kernels
    keep, size = {}, {}
    label = [None]
    orig = {k: getattr(kernels, k) for k in FITTED}

    def watched(name, f):
        def g(*a):
            out = f(*a)
            key = (label[0], name)
            if out.numel() > size.get(key, -1):
                size[key] = out.numel()
                keep[key] = ((tuple(a[0].shape), a[1])
                             if name in ("fitted_rows", "fitted_rows_t")
                             else (tuple(out.shape),
                                   tuple(t.clone() for t in a[:-1])
                                   + (a[-1],)))
            return out
        g.launches = f.launches
        return g

    for name, f in orig.items():
        setattr(kernels, name, watched(name, f))
    try:
        for label[0], f in steps:
            f()
        torch.cuda.synchronize()
    finally:
        for name, f in orig.items():
            setattr(kernels, name, f)
    if any(k not in keep for k in want):
        raise AssertionError(f"the watched calls ran {sorted(keep)}")
    return {k: keep[k] for k in want}


def _core_call(inputs, label):
    """K6's linear map at the tangent mode's call of ``label``: R D rows
    of its plan's tables (region A's 1,600 rows of PR 15's record). No
    path launches the linear map at this shape: its records there are
    the comparison with the map's first design, marked off the path; its
    record on the path is the 256 gammas' call."""
    shape, args = inputs[(label, "fitted_eval_jvp")]
    R, D, G = shape[:3]
    tab = args[-1].tables
    return (R * D, G, tab.K, tab.n_max), tab


def _capture_fitted(fn, q0, shocks, device) -> dict:
    """K6's and K7's largest calls (``_watch_fitted``) in regions A, C1
    and C2 of one staged chunk; K6's linear map at A's and C1's tangent
    calls (``_core_call``: off the path, since no region launches it)."""
    import torch
    sh = torch.as_tensor(shocks[:fn.chunk(shocks.shape[0])], device=device)
    q = torch.as_tensor(q0, device=device)[None, :] + sh
    r, st = fn.regions, {}
    steps = [("A", lambda: st.update(a=r["A"](q))),
             ("C1", lambda: st.update(v=r["C1"](q, st["a"]["g"],
                                                st["a"]["carry"])[1])),
             ("C2", lambda: r["C2"](q, st["a"]["g"], st["v"]))]
    got = _watch_fitted(steps, [("A", "fitted_eval"),
                                ("A", "fitted_eval_jvp"),
                                ("C2", "fitted_rows_t"),
                                ("C1", "fitted_eval"),
                                ("C1", "fitted_eval_jvp"),
                                ("C1", "fitted_rows_t")])
    for label in ("A", "C1"):
        got[(label, "fitted_rows")] = _core_call(got, label)
    return got


def _xccy_routes(name, mb) -> dict:
    """Print and return each XCCY stage's route (K8-K11 or torch.func),
    decided when the book compiled."""
    from adrates_torch.ops.xccy_stage import stage_routes
    from adrates_torch.parallel.multibook import book_inputs
    topo = book_inputs(mb).topology
    routes = {}
    for si, r in ({} if topo is None else stage_routes(topo)).items():
        st = topo.stages[si]
        names = ", ".join(topo.specs[c].name for c in st.ids)
        routes[f"{st.key} ({names})"] = r
    print(f"{name}: XCCY stage routes {routes}", flush=True)
    return routes


def _xccy_launches(path: str, info: dict, hess: bool = True) -> dict:
    """Report K8-K11 launches a call on one path whose XCCY stages take
    the kernels (``info``: its launch counts and ``calls``): K8 and K9
    must have launched, and K10 and K11 too where the path takes the
    stage's Hessian. Returns them a call."""
    n = info["calls"]
    per = {k: info[k] / n for k in XCCY}
    print(f"{path}: K8-K11 (xccy_stage_jvp, xccy_legs_jvp, "
          f"xccy_stage_hess, xccy_legs_hess) "
          f"{[per[k] for k in XCCY]} launches a call ({n} calls)",
          flush=True)
    need = XCCY if hess else XCCY[:2]
    if any(info[k] <= 0 for k in need):
        raise AssertionError(f"{path}: the XCCY stage kernels were not "
                             f"launched ({ {k: info[k] for k in XCCY} })")
    return per


def _capture_xccy(run, per_stage: bool = False, names=XCCY) -> dict:
    """Run ``run()`` with the wrappers ``names`` (K8-K11's) watched: per
    kernel, the arguments of its first call (the first scenario chunk),
    tensors copied; with ``per_stage``, a list of such dicts, one for each
    XCCY stage in the order its tables first reach a kernel. The kernels'
    own launch counts are left as they were."""
    import torch

    from adrates_torch.ops import kernels
    keep = {}
    order = []
    orig = {k: getattr(kernels, k) for k in names}

    def watched(name, f):
        def g(*args):
            tab = id(args[0]) if per_stage else 0
            if tab not in order:
                order.append(tab)
            if (tab, name) not in keep:
                keep[tab, name] = tuple(
                    a.clone() if isinstance(a, torch.Tensor) else a
                    for a in args)
            return f(*args)
        g.launches = f.launches
        return g

    for name, f in orig.items():
        setattr(kernels, name, watched(name, f))
    try:
        run()
        torch.cuda.synchronize()
    finally:
        for name, f in orig.items():
            setattr(kernels, name, f)
    out = [{name: keep[tab, name] for name in names if (tab, name) in keep}
           for tab in order]
    for got in out:
        if sorted(got) != sorted(orig):
            raise AssertionError(f"the watched call ran {sorted(got)} only")
    return out if per_stage else out[0]


def _watch_reach():
    """Record every static fitted plan built from now on (each member of
    each ``kernels.fitted_tables`` call): its kind, knots, queries and
    its farthest query past its last knot in lengths of its last interval
    (0 where none lies past it). Returns (the records, a function that
    stops the recording)."""
    import numpy as np

    from adrates_torch.ops import kernels
    orig = kernels.fitted_tables
    recs = []

    def watch(members, device):
        for x, q, _, kind in members:
            x = np.asarray(x, np.float64)
            q = np.asarray(q, np.float64).reshape(-1)
            far = float(q.max() - x[-1]) / float(x[-1] - x[-2]) \
                if q.size else 0.0
            recs.append(dict(kind=int(kind), knots=int(x.shape[0]),
                             queries=int(q.size), reach=max(0.0, far)))
        return orig(members, device)

    kernels.fitted_tables = watch

    def stop():
        kernels.fitted_tables = orig
    return recs, stop


def _reach_summary(recs) -> dict:
    """The farthest reach of the recorded plans, for the splines (natural
    and clamped, whose solve extrapolates as a cubic) and for PCHIP: the
    reach and the knots and queries of its member."""
    from adrates_torch.ops import kernels
    out = dict(plans=len(recs))
    for label, kinds in (("spline", (kernels.FIT_NATURAL,
                                     kernels.FIT_CLAMPED)),
                         ("pchip", (kernels.FIT_HERMITE,))):
        mine = [r for r in recs if r["kind"] in kinds]
        if mine:
            out[label] = max(mine, key=lambda r: r["reach"])
    return out


def _region_device(fn, q0, shocks, device) -> dict:
    """Regions A, C1 and C2 of a staged fn on its first chunk: the device
    ops and device ms of one warm call of each (``_request_device``)."""
    import torch
    sh = torch.as_tensor(shocks[:fn.chunk(shocks.shape[0])], device=device)
    q = torch.as_tensor(q0, device=device)[None, :] + sh
    r = fn.regions
    a = r["A"](q)
    _, v_of = r["C1"](q, a["g"], a["carry"])
    out = {}
    for name, f in (("A", lambda: r["A"](q)),
                    ("C1", lambda: r["C1"](q, a["g"], a["carry"])),
                    ("C2", lambda: r["C2"](q, a["g"], v_of))):
        ops, ms = _request_device(f)
        out[name] = dict(device_ops=ops, device_ms=ms)
    return out


# the spline cell's regions on the first 50-scenario chunk with its XCCY
# stages on torch.func (PERF.md section 5, scripts/fitted_ab.py; NVIDIA
# H100 80GB HBM3, 700.00 W): device ops, device ms
SPLINE_REGIONS_TORCH_FUNC = dict(A=(1296, "4.74-4.76"), C1=(4351, "9.96-10.02"),
                             C2=(871, "4.34-4.36"))


def _nested_forward_raises(curve, device) -> dict:
    """The forward-mode rule of ``ops/linear_solve`` on this torch, on the
    card: ``forward_levels`` (torch's private functorch interpreter stack)
    counts one level under ``jacfwd(jacrev)`` and two under
    ``jacfwd(jacfwd)``, where the bootstrap raises ``LibError``."""
    import numpy as np
    import torch
    from torch.func import jacfwd, jacrev

    from adrates_torch.ops import linear_solve
    from adrates_torch.ops.bootstrap import bootstrap_ois, plan_to_torch
    from adrates_torch.utils import LibError
    plan = plan_to_torch(curve._plan, device)
    r = torch.as_tensor(np.asarray(curve.swap_rates), device=device)
    seen = []

    def pv(x):
        seen.append(linear_solve.forward_levels())
        return bootstrap_ois(x, plan)[1].sum()

    jacfwd(jacrev(pv))(r)
    try:
        jacfwd(jacfwd(pv))(r)
        raised = False
    except LibError:
        raised = True
    if seen != [1, 2] or not raised:
        raise AssertionError(f"forward levels seen {seen}, raised {raised}")
    print(f"nested forward mode on torch {torch.__version__}: levels "
          f"{seen}, jacfwd(jacfwd) through the bootstrap raised LibError",
          flush=True)
    return dict(levels=seen, raised=raised, torch=torch.__version__)


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
    _xccy_routes(name, mb)


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
    info["ois_per_call"] = _ois_launches("ois structured", info,
                                         _ois_routes("ois", mb))
    _call_device("ois structured", fn, q0, shocks, info)
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


def _call_device(name, fn, q0, shocks, info):
    """The device ops and device ms of one warm ``fn(q0, shocks)`` call (a
    CUDA-only profiler trace), kept in ``info`` and printed."""
    info["device_ops"], info["device_ms"] = _request_device(
        lambda: fn(q0, shocks))
    print(f"{name}: one warm call {info['device_ops']} device ops, "
          f"{_fmt_ms(info['device_ms'])} of device time; card "
          f"{_card_line()}", flush=True)


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
    info["ois_per_call"] = _ois_launches("xccy staged", info,
                                         _ois_routes("xccy", mb))
    info["regions_ms"], a = _time_regions(fn, q0, shocks, device)
    _print_regions("xccy", a["dfs"].shape[0], info["regions_ms"])
    del a

    mono = make_multibook_fn(mb, device=device)
    check_outputs("xccy", out, mono, q0, shocks, mb.n_trades,
                  fd_extra=(_top_quote(mb, out["delta"][0], "xccy"),))
    _check_staged_vs_mono("xccy", out, mono, q0, shocks)
    return mono, mb, q0, shocks, info


def run_flagship_v5(device, n_warm: int = 3):
    """Phase 7: the flagship_v5 book through the staged regions; returns
    its fns, book, quotes, shocks, info and model."""
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
    routes = _ois_routes("flagship_v5", mb)
    info["ois_per_call"] = _ois_launches("flagship_v5 staged", info, routes)
    _call_device("flagship_v5 staged", fn, q0, shocks, info)
    info["regions_device"] = _region_device(fn, q0, shocks, device)
    print("flagship_v5 regions on the first chunk, device ops and device "
          "ms: " + "; ".join(f"{k} {v['device_ops']} ops, "
                             f"{_fmt_ms(v['device_ms'])}"
                             for k, v in info["regions_device"].items())
          + f"; card {_card_line()}", flush=True)

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
        dv = _device_stats(f)
        info[f"{key}_device_ms"] = dv and dv["median"]
        info[f"{key}_kernels"] = dv["kernels"] if dv else 0
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
    before = _launches()
    _check_staged_vs_mono("flagship_v5", out, mono, q0, shocks)
    info["mono_ois_per_call"] = _ois_launches(
        "flagship_v5 monolithic", _launches_since(before, 1), routes)
    # the staged results phase 7f holds the sharded function to
    info["ref"] = dict(total_pv=out["pvs"].sum(dim=1), delta=out["delta"],
                       gamma=out["gamma"])
    del out
    torch.cuda.empty_cache()
    return fn, mono, mb, q0, shocks, info, model


def _select_trades(mb, n_sel=256):
    """``bench.py``'s per-trade gamma selection size: 256 of the tiled
    trades from ``default_rng(7)``, with a capped/floored FRN and a trade
    on a recalibrated XCCY curve put in place of the last two draws when
    the draw holds none. Returns (trade ids, position of the FRN, position
    of the XCCY trade)."""
    import numpy as np

    from adrates_torch.parallel import pertrade_blocks as tpb
    B = mb.tile.base_trades
    sel = np.random.default_rng(7).choice(mb.n_trades, n_sel, replace=False)
    capped = np.unique(np.asarray(mb.clamp.slot_trade))
    xccy = [c for c, sp in enumerate(mb.basket.specs) if sp.kind == "xccy"]
    on_xccy = np.nonzero(tpb._touched_sets(mb)[:, xccy].any(axis=1))[0]
    if not mb.basket.recalibrate_xccy or not on_xccy.size:
        raise AssertionError("flagship_v5 has no recalibrated XCCY trade")
    pos = []
    for k, cand in ((n_sel - 1, capped), (n_sel - 2, on_xccy)):
        hit = np.nonzero(np.isin(sel % B, cand))[0]
        if hit.size:
            pos.append(int(hit[0]))
            continue
        t = int(cand[0]) + B           # the candidate's second copy
        if t in sel:
            raise AssertionError(f"trade {t} already selected")
        sel[k] = t
        pos.append(k)
    return sel, pos[0], pos[1]


def _pertrade_routes(mb) -> dict:
    """Each XCCY stage's per-trade route (K12, K9, K11 split at its node
    DFs, or the torch.func towers and why), keyed as ``_xccy_routes``,
    and whether each such stage is recalibrated."""
    from adrates_torch.ops.xccy_stage import pertrade_routes
    from adrates_torch.parallel.multibook import book_inputs
    topo = book_inputs(mb).topology
    out = {}
    for si, r in ({} if topo is None else pertrade_routes(topo)).items():
        st = topo.stages[si]
        names = ", ".join(topo.specs[c].name for c in st.ids)
        out[f"{st.key} ({names})"] = (r, bool(st.recal))
    return out


def run_per_trade(device, staged, mono, mb, q0, n_warm: int = 3,
                  node_route: bool = True):
    """Phase 7b: the per-trade paths on phase 7's flagship_v5 book: every
    trade's delta ladder (K1), 256 selected trades' dense gammas (K3 at
    k = N) and every trade's own-block gamma (K3 over the signature
    groups), each driven cold + ``n_warm`` warm with its own launch
    counts (``staged`` and ``mono`` are phase 7's fns), then checked;
    the device ops and device ms of one warm call of the gammas and the
    blocks (a CUDA-only trace); each XCCY stage's per-trade route
    (``node_route``: gated, every stage on K12, K9 and K11) and those
    kernels' launches a call on both paths (gated: launched where a stage
    takes the route, K12 not launched where none does); and, where a
    stage takes it, the arguments of K12, K9 and K11 in one warm call of
    the gammas for phase 8 (``infos["node_inputs"]``). Returns (the three
    fns, infos)."""
    import numpy as np
    import torch

    from adrates_torch.parallel import (dense_from_block,
                                        make_per_trade_delta_fn,
                                        make_per_trade_gamma_blocks_fn,
                                        make_per_trade_gamma_fn)
    card = _card_line()
    N = mb.basket.n_quotes
    sel, i_frn, i_x = _select_trades(mb)
    infos = {}

    lad_fn = make_per_trade_delta_fn(mb, device)
    lad, infos["ladders"] = _drive(
        f"per-trade ladders [{mb.n_trades} x {N}]",
        lambda q, _: lad_fn(q), q0, None, n_warm)
    # one trade-major K1 launch a call writes the [B, N] ladders
    infos["ladders"]["pvs_sweep_tm_f64"] = infos["ladders"]["pvs_sweep"]
    if infos["ladders"]["pvs_sweep"] != infos["ladders"]["calls"]:
        raise AssertionError(f"ladders: K1 launched "
                             f"{infos['ladders']['pvs_sweep']} times in "
                             f"{infos['ladders']['calls']} calls")
    gam_fn = make_per_trade_gamma_fn(mb, sel, device)
    gam, infos["gamma_256"] = _drive(
        f"per-trade gammas [{len(sel)} x {N} x {N}]",
        lambda q, _: gam_fn(q), q0, None, n_warm)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    blk_fn = make_per_trade_gamma_blocks_fn(mb, device)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    groups, infos["blocks"] = _drive(
        f"per-trade gamma blocks [{mb.n_trades} trades]",
        lambda q, _: blk_fn(q), q0, None, n_warm)
    infos["blocks"]["build_ms"] = build_ms
    for key in ("ladders", "gamma_256", "blocks"):
        _solve_launches(f"per-trade {key}", infos[key],
                        reverse=key != "ladders")
    k_max = max(k for _, k, _ in blk_fn.group_meta)
    print(f"per-trade gamma blocks: builder {build_ms:.1f} ms (host "
          f"harvest + device tables); {blk_fn.n_groups} groups, k_max "
          f"{k_max}, {sum(bg for *_, bg in blk_fn.group_meta)} base "
          f"trades, K3 {blk_fn.k3.units.shape[0]} units in "
          f"{blk_fn.k3.packs.shape[0]} blocks; card {card}",
          flush=True)
    # the J pass at q0 alone (each fn's prep: grids, structured J and the
    # kernel's operands), median of 3 separate calls; a warm call adds
    # the kernel and, for the gammas, the stage tensors and contractions
    for key, f in (("ladders", lad_fn), ("gamma_256", gam_fn),
                   ("blocks", blk_fn)):
        i = infos[key]
        i["prep_ms"] = statistics.median(_timed(lambda: f.prep(q0))[1]
                                         for _ in range(3))
        print(f"per-trade {key}: warm median "
              f"{statistics.median(i['warm_ms']):.1f} ms; the J pass alone "
              f"(prep) {i['prep_ms']:.1f} ms; peak {i['peak_gib']:.2f} GiB; "
              f"card {card}", flush=True)
    for key, name in (("ladders", "pvs_sweep"), ("gamma_256",
                                                 "pertrade_quad_form"),
                      ("blocks", "pertrade_quad_form")):
        if infos[key][name] <= 0:
            raise AssertionError(f"{name} was not launched on the per-trade "
                                 f"{key} path")

    # ---- the XCCY stages' per-trade tensors: K12, K9, K11 ---------------
    routes = _pertrade_routes(mb)
    infos["routes"] = {k: r for k, (r, _) in routes.items()}
    print(f"per-trade: XCCY stage per-trade routes {infos['routes']}; card "
          f"{card}", flush=True)
    on = [recal for r, recal in routes.values() if r == "kernels"]
    if node_route and (not routes or len(on) < len(routes)):
        raise AssertionError(f"per-trade: an XCCY stage keeps the torch.func "
                             f"towers: {infos['routes']}")
    for key, f in (("gamma_256", gam_fn), ("blocks", blk_fn)):
        i = infos[key]
        per = {k: i[k] / i["calls"] for k in NODE}
        i["device_ops"], i["device_ms"] = _request_device(lambda: f(q0))
        print(f"per-trade {key}: K12 xccy_stage_node_hess, K9 "
              f"xccy_legs_jvp, K11 xccy_legs_hess "
              f"{[per[k] for k in NODE]} launches a call ({i['calls']} "
              f"calls); one warm call {i['device_ops']} device ops, device "
              f"{_fmt_ms(i['device_ms'])}; card {card}", flush=True)
        need = NODE if any(on) else NODE[:1] if on else ()
        if any(i[k] <= 0 for k in need):
            raise AssertionError(f"per-trade {key}: the node split's kernels "
                                 f"were not launched "
                                 f"({ {k: i[k] for k in NODE} })")
        if not on and i["xccy_stage_node_hess"]:
            raise AssertionError(f"per-trade {key}: K12 launched with no "
                                 f"XCCY stage on its route")
    if on:
        infos["node_inputs"] = _capture_xccy(
            lambda: gam_fn(q0), names=NODE if any(on) else NODE[:1])

    # ---- checks -------------------------------------------------------
    zero = np.zeros((1, N))
    book = staged(q0, zero)
    delta0, gamma0 = book["delta"][0], book["gamma"][0]
    _check("per-trade sum_b ladder == staged book delta (rel)",
           float((lad.sum(dim=0) - delta0).abs().max()
                 / delta0.abs().max()), 1e-9)
    h = 1e-6
    for label, i in (("capped FRN", i_frn), ("XCCY", i_x)):
        t = int(sel[i])
        j = int(lad[t].abs().argmax())
        e = np.zeros((1, N))
        e[0, j] = h
        fd = float(mono.pvs_only(q0, e)[0, t] - mono.pvs_only(q0, -e)[0, t]) \
            / (2 * h)
        _check(f"per-trade ladder of the {label} (trade {t}) at quote {j} "
               f"vs central FD of its PV (rel)",
               abs(fd - float(lad[t, j])) / abs(fd), 1e-5)
    total = torch.zeros((N, N), dtype=torch.float64, device=device)
    for g in groups:
        q = torch.as_tensor(g.qidx, dtype=torch.int64, device=device)
        total[q[:, None], q[None, :]] += g.blocks.sum(dim=0)
    _check("per-trade blocks summed == staged book gamma (rel)",
           float((total - gamma0).abs().max() / gamma0.abs().max()), 1e-9)
    _check("per-trade selected gammas symmetric (rel, worst trade)",
           max(float((g - g.T).abs().max() / max(float(g.abs().max()),
                                                  1e-300)) for g in gam),
           1e-10)
    where = {int(t): (g, p) for g in groups
             for p, t in enumerate(g.trade_ids)}
    worst, n_empty = 0.0, 0
    for i, t in enumerate(sel):
        if int(t) not in where:
            # a trade with no live slot is in no group, and its dense
            # gamma is exactly zero
            n_empty += 1
            if bool(gam[i].any()):
                raise AssertionError(f"trade {t} is in no block group but "
                                     f"has a nonzero gamma")
            continue
        g, p = where[int(t)]
        d = torch.as_tensor(dense_from_block(g, p, N), device=device)
        worst = max(worst, float((d - gam[i]).abs().max()
                                 / gam[i].abs().max()))
    _check(f"per-trade selected gamma == dense_from_block (rel, worst "
           f"trade; {n_empty} trades without a live slot exactly zero)",
           worst, 1e-10)
    infos["n_groups"], infos["k_max"] = blk_fn.n_groups, k_max
    del lad, gam, groups, book, total
    torch.cuda.empty_cache()
    return (lad_fn, gam_fn, blk_fn), infos


ENGINE_ROUTES = ["ois", "ois_usd_collateral", "xccy_basis", "xccy_fix_float",
                 "xccy_fix_fix", "zcis", "yoy", "bond", "frn_capped"]


def _route_trades(trades, coll, value_dt):
    """The first live base trade (maturing after ``value_dt``) of every
    engine route, in the book's order: (route, trade, collateral type).
    The natural OIS and the inflation swaps are GBP; the YoY swap's first
    CPI window starts on its effective date (a stub's starts a year before
    the payment, earlier than the index can project without fixings, and
    the host ``value`` raises there); the capped FRN is one whose last
    payment falls on its maturity date (the host ``value`` discounts the
    principal at the maturity date, the engine at the last payment)."""
    from adrates_torch.trades.credit import FRN, Bond
    from adrates_torch.trades.rates import (OIS, XccyBasisSwap, XccyFixFix,
                                            XccyFixFloat, YoYInflationSwap,
                                            ZeroCouponInflationSwap)
    from adrates_torch.utils import CurrencyTypes
    tests = dict(
        ois=lambda t, c: isinstance(t, OIS) and c is None
        and t._currency == CurrencyTypes.GBP,
        ois_usd_collateral=lambda t, c: isinstance(t, OIS) and c is not None,
        xccy_basis=lambda t, c: isinstance(t, XccyBasisSwap),
        xccy_fix_float=lambda t, c: isinstance(t, XccyFixFloat),
        xccy_fix_fix=lambda t, c: isinstance(t, XccyFixFix),
        zcis=lambda t, c: isinstance(t, ZeroCouponInflationSwap)
        and t._inflation_index._currency == CurrencyTypes.GBP,
        yoy=lambda t, c: isinstance(t, YoYInflationSwap)
        and t._inflation_index._currency == CurrencyTypes.GBP
        and t._inflation_leg._yoy_start_dts[0] >= t._effective_dt,
        bond=lambda t, c: isinstance(t, Bond),
        frn_capped=lambda t, c: isinstance(t, FRN)
        and t._cap_rate is not None
        and t._maturity_dt == t._payment_dts[-1])
    return [(name,) + next((t, c) for t, c in zip(trades, coll)
                           if t._maturity_dt > value_dt
                           and tests[name](t, c))
            for name in ENGINE_ROUTES]


def _direct_value(model, trade, coll) -> float:
    """A trade's own host ``value(...)`` on the model's curves."""
    from adrates_torch.trades.rates.xccy_curve import find_xccy_curve
    from adrates_torch.utils import (CollateralType, collateral_to_currency,
                                     get_discount_curve_name)

    def ois_of(ccy):
        return model.curves[get_discount_curve_name(ccy,
                                                    CollateralType[ccy.name])]
    v = model.value_dt
    kind = trade.derivative_type.name
    if kind == "OIS_SWAP":
        ois = model.curves[trade._floating_index.name]
        if coll is None:
            return trade.value(v, ois)
        ccy = collateral_to_currency(coll)
        xc = model.curves[get_discount_curve_name(trade._currency, coll)]
        return trade.value(v, ois, xccy_discount_curve=xc,
                           spot_fx=model.fx(f"{ccy.name}"
                                            f"{trade._currency.name}"),
                           collateral_type=coll)
    if kind == "XCCY_SWAP":
        _, xc = find_xccy_curve(model, trade)
        return trade.value(
            v, model.curves[trade._domestic_floating_index.name],
            model.curves[trade._foreign_floating_index.name],
            xccy_discount_curve=xc, spot_fx=xc._spot_fx)
    if kind in ("ZCIS", "YOY_INFLATION_SWAP"):
        index = trade._inflation_index
        return trade.value(v, ois_of(index._currency), index._inflation_curve)
    if kind == "BOND":
        return trade.value(v, ois_of(trade._currency))
    return trade.value(v, ois_of(trade._currency),
                       model.curves[trade._floating_index.name])


def _gamma_blocks(res):
    """A result's gamma blocks by curve (cross-gammas apart)."""
    g = res.gamma
    if hasattr(g, "_by_curve"):
        return {n: x.risk_ladder for n, x in g._by_curve.items()}
    return {g.curve_type.name: g.risk_ladder}


def _result_arrays(res):
    """(value, every delta ladder and gamma block flattened) of a result,
    for holding two engines' results together."""
    import numpy as np
    parts = [np.array([res.value.amount])]
    for obj in (res.risk, res.gamma):
        ls = obj._by_curve.values() if hasattr(obj, "_by_curve") else [obj]
        parts += [np.ravel(x.risk_ladder) for x in ls]
        if hasattr(obj, "_cross_gammas"):
            parts += [np.ravel(c.risk_matrix)
                      for c in obj._cross_gammas.values()]
    return parts


def _drive_request(p, reqs, n):
    """One engine request on a position: cold, then ``n`` warm on the host
    clock; returns (result, dict(cold_ms, warm_ms stats))."""
    out, cold = _timed(lambda: p.compute(reqs))
    warm = [_timed(lambda: p.compute(reqs))[1] for _ in range(n)]
    return out, dict(cold_ms=cold, warm_ms=_stats(warm))


def _config2_swap(model, cpn: float = 0.0387):
    """``bench.py``'s config-2 trade: a 10Y RECEIVE 0.0387 OIS on the
    model's GBP_OIS_SONIA, 10M notional, MODIFIED_FOLLOWING (struck at
    ``cpn`` when given)."""
    from adrates_torch.trades.rates import OIS
    from adrates_torch.utils import (BusDayAdjustTypes, CurrencyTypes,
                                     CurveTypes, DayCountTypes,
                                     FrequencyTypes, SwapTypes)
    return OIS(model.value_dt, "10Y", SwapTypes.RECEIVE, cpn,
               FrequencyTypes.ANNUAL, DayCountTypes.ACT_365F,
               CurveTypes.GBP_OIS_SONIA, CurrencyTypes.GBP,
               notional=10_000_000, float_dc_type=DayCountTypes.ACT_365F,
               bd_type=BusDayAdjustTypes.MODIFIED_FOLLOWING)


def _cuda_vs_cpu(name, res, res_cpu) -> float:
    """Gates the card's result against the CPU-asked-for engine's at
    1e-12 (ladders and gammas of their largest, the PV of max(|PV|, 1));
    returns the larger error."""
    import numpy as np
    err = max(float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))
              for a, b in zip(_result_arrays(res)[1:],
                              _result_arrays(res_cpu)[1:]))
    err_pv = abs(res.value.amount - res_cpu.value.amount)
    _check(f"{name} cuda vs cpu ladders and gammas (abs / max|ref|)", err,
           1e-12)
    _check(f"{name} cuda vs cpu PV (abs / max(|ref|, 1))",
           err_pv / max(abs(res_cpu.value.amount), 1.0), 1e-12)
    return max(err, err_pv)


def run_engine(device, model, trades, coll, n_warm: int = 20):
    """Phase 7c: the single-trade engine on the card (no kernel of its
    own): the README quick start; ``bench.py``'s config 2 on
    flagship_v5's GBP curve (cold + ``n_warm`` warm requests, SPEED, the
    device ops of one request, the same request on an engine asked for
    the CPU, a central FD of the 10Y delta) and config 1 (100 warm
    bootstraps); one trade of every route from phase 7's base trades;
    the engine against the book (PVs, and the K1 per-trade ladders); a
    Portfolio of the route trades. Returns the ``engine`` record."""
    import numpy as np
    import torch

    from adrates_torch.examples import flagship_ois
    from adrates_torch.market import Portfolio
    from adrates_torch.models import Model
    from adrates_torch.ops.bootstrap import bootstrap_ois, plan_to_torch
    from adrates_torch.parallel import (compile_multibook,
                                        make_multibook_fn,
                                        make_per_trade_delta_fn)
    from adrates_torch.trades.rates import OIS
    from adrates_torch.utils import (CurrencyTypes, CurveTypes, Date,
                                     DayCountTypes, FrequencyTypes,
                                     InterpTypes, RequestTypes, SwapTypes)
    R = RequestTypes
    VDG = [R.VALUE, R.DELTA, R.GAMMA]
    card = _card_line()
    rec = dict(card=card, parts_s={})
    t_phase = t_mark = time.perf_counter()
    _reset_launches()

    def mark(part):
        """Seconds since the previous mark, kept under ``part``."""
        nonlocal t_mark
        now = time.perf_counter()
        rec["parts_s"][part] = now - t_mark
        t_mark = now

    def finite(res, name):
        for a in _result_arrays(res):
            if not np.isfinite(a).all():
                raise AssertionError(f"engine {name}: non-finite output")

    # ---- the README quick start ------------------------------------------
    qs = Model(Date(1, 1, 2024))
    qs.build_curve("GBP_OIS_SONIA",
                   px_list=[5.19, 4.71, 4.35, 3.93, 3.87, 3.71],
                   tenor_list=["1M", "1Y", "2Y", "5Y", "10Y", "30Y"],
                   fixed_dcc_type=DayCountTypes.ACT_365F,
                   float_dc_type=DayCountTypes.ACT_365F)
    swap = OIS(Date(1, 1, 2024), "10Y", SwapTypes.RECEIVE, 0.0387,
               FrequencyTypes.ANNUAL, DayCountTypes.ACT_365F,
               CurveTypes.GBP_OIS_SONIA, CurrencyTypes.GBP,
               notional=10_000_000, float_dc_type=DayCountTypes.ACT_365F)
    res, ms = _timed(lambda: swap.position(qs).compute(VDG))
    finite(res, "quick start")
    lad, gam = res.risk.risk_ladder, res.gamma.risk_ladder
    i, j = int(np.abs(lad).argmax()), int(np.abs(np.diag(gam)).argmax())
    rec["quick_start"] = dict(pv=res.value.amount, cold_ms=ms,
                              max_bucket=[res.risk.tenors[i], float(lad[i])],
                              max_gamma_diag=[res.gamma.tenors[j],
                                              float(gam[j, j])])
    _check("engine quick start PV vs direct value (abs)",
           abs(res.value.amount - swap.value(qs.value_dt,
                                             qs.curves.GBP_OIS_SONIA)), 1e-6)
    print(f"engine quick start on {res.risk.tenors[0]}..{res.risk.tenors[-1]}"
          f" GBP: PV {res.value.amount:.6f} GBP; largest bucket "
          f"{res.risk.tenors[i]} {lad[i]:.6f} GBP/bp; largest gamma "
          f"diagonal {res.gamma.tenors[j]} {gam[j, j]:.9f} GBP/bp^2; first "
          f"request {ms:.1f} ms", flush=True)
    mark("quick start")

    # ---- bench.py config 2 on flagship_v5's GBP curve --------------------
    curve = model.curves.GBP_OIS_SONIA
    swap = _config2_swap(model)
    pos = swap.position(model, device=device)
    before = _launches()
    res, rec["config2"] = _drive_request(pos, VDG, n_warm)
    rec["config2"]["launches"] = _launches_since(before, 1 + n_warm)
    _solve_launches("engine config 2", rec["config2"]["launches"])
    finite(res, "config 2")
    before = _launches()
    res_s, rec["config2_speed"] = _drive_request(pos, [R.SPEED], 5)
    rec["config2_speed"]["launches"] = _launches_since(before, 6)
    _solve_launches("engine config 2 SPEED",
                    rec["config2_speed"]["launches"])
    rec["solve_inputs"] = _capture_solves(lambda: pos.compute(VDG))
    rec["nested_forward"] = _nested_forward_raises(curve, device)
    for key, reqs in (("config2", VDG), ("config2_speed", [R.SPEED])):
        n_ops, d_ms = _request_device(lambda: pos.compute(reqs))
        rec[key].update(device_ops=n_ops, device_ms=d_ms)
    mark("config 2 and SPEED on the card, their device ops")
    cpu_pos = swap.position(model, device="cpu")
    res_cpu, rec["config2_cpu"] = _drive_request(cpu_pos, VDG, n_warm)
    rec["config2"]["cuda_vs_cpu_err"] = _cuda_vs_cpu("engine config 2", res,
                                                     res_cpu)
    mark("config 2 on the CPU")

    tenors, rates = flagship_ois.MAIN_TENORS, flagship_ois.MAIN_RATES
    k10 = tenors.index("10Y")
    pv_bumped = []
    for h in (0.01, -0.01):                   # +-1 bp, quotes in percent
        m = Model(model.value_dt)
        m.build_curve("GBP_OIS_SONIA",
                      px_list=[r + (h if k == k10 else 0.0)
                               for k, r in enumerate(rates)],
                      tenor_list=tenors,
                      fixed_dcc_type=DayCountTypes.ACT_365F,
                      float_dc_type=DayCountTypes.ACT_365F,
                      interp_type=InterpTypes.FLAT_FWD_RATES)
        pv_bumped.append(swap.position(m, device=device).compute(
            [R.VALUE]).value.amount)
    fd = (pv_bumped[0] - pv_bumped[1]) / 2.0  # per bp
    ad = float(res.risk.risk_ladder[k10])
    _check("engine config 2 DELTA at 10Y vs central FD of VALUE on models "
           "rebuilt +-1bp (rel)", abs(ad - fd) / abs(fd), 1e-5)
    rec["config2"].update(delta_10y=ad, fd_10y=fd)
    mark("FD of the 10Y delta")

    plan = plan_to_torch(curve._plan, device)
    r = torch.as_tensor(np.asarray(curve.swap_rates), device=device)
    bootstrap_ois(r, plan)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        out = bootstrap_ois(r, plan)
    torch.cuda.synchronize()
    rec["config1_bootstrap_ms"] = (time.perf_counter() - t0) / 100 * 1e3
    del out
    mark("config 1")
    c2, cs, cc = rec["config2"], rec["config2_speed"], rec["config2_cpu"]
    print(f"engine config 2 (flagship_v5 GBP_OIS_SONIA, "
          f"{len(curve.swap_rates)} pillars, 10Y RECEIVE 0.0387, 10M): "
          f"VALUE+DELTA+GAMMA cold {c2['cold_ms']:.1f} ms, warm median "
          f"{c2['warm_ms']['median']:.2f} [{c2['warm_ms']['min']:.2f}, "
          f"{c2['warm_ms']['max']:.2f}] ms over {n_warm}; one request "
          f"{c2['device_ops']} device ops, {_fmt_ms(c2['device_ms'])} of "
          f"device time; SPEED cold {cs['cold_ms']:.1f} ms, warm median "
          f"{cs['warm_ms']['median']:.2f} [{cs['warm_ms']['min']:.2f}, "
          f"{cs['warm_ms']['max']:.2f}] ms over 5, {cs['device_ops']} "
          f"device ops, {_fmt_ms(cs['device_ms'])}; engine asked for the "
          f"CPU: warm median {cc['warm_ms']['median']:.2f} "
          f"[{cc['warm_ms']['min']:.2f}, {cc['warm_ms']['max']:.2f}] ms; "
          f"config 1 bootstrap {rec['config1_bootstrap_ms']:.3f} ms a call "
          f"(100 warm); card {card}", flush=True)

    # ---- one trade of every route ---------------------------------------
    routes = _route_trades(trades, coll, model.value_dt)
    results = {}
    rec["routes"] = {}
    for name, trade, c in routes:
        reqs = VDG + ([R.CASHFLOWS] if name in ("ois", "bond", "frn_capped")
                      else [])
        p = trade.position(model, device=device)
        out, cold = _timed(lambda: p.compute(reqs, c))
        out, warm = _timed(lambda: p.compute(reqs, c))
        finite(out, name)
        if R.CASHFLOWS in reqs and not len(out.cashflows):
            raise AssertionError(f"engine {name}: no cashflows")
        blocks = _gamma_blocks(out)
        scale = max(float(np.abs(g).max()) for g in blocks.values())
        asym = max(float(np.abs(g - g.T).max()) for g in blocks.values())
        if scale == 0.0:
            raise AssertionError(f"engine {name}: zero gamma")
        _check(f"engine {name} gamma blocks symmetric (abs / max|gamma|)",
               asym / scale, 1e-10)
        direct = _direct_value(model, trade, c)
        _check(f"engine {name} PV vs direct value (abs, bound max(1e-6, "
               f"1e-12 |PV|))", abs(out.value.amount - direct),
               max(1e-6, 1e-12 * abs(direct)))
        results[name] = out
        rec["routes"][name] = dict(pv=out.value.amount,
                                   currency=out.value.currency.name,
                                   direct=direct, cold_ms=cold,
                                   warm_ms=warm)
        print(f"engine {name}: PV {out.value.amount:.6f} "
              f"{out.value.currency.name} (direct {direct:.6f}); cold "
              f"{cold:.1f} ms, warm {warm:.1f} ms", flush=True)

    mark("the route trades")
    # the engine's path launches K4 / K5 and none of K1-K3 (read before
    # the book gate)
    rec["main_path_launches"] = _launches()
    print(f"engine main path kernel launches: {rec['main_path_launches']}",
          flush=True)

    # ---- the engine against the book (K1 ladders) ------------------------
    by = {n: (t, c) for n, t, c in routes}
    pair = [by["ois"][0], by["zcis"][0]]
    with warnings.catch_warnings():        # curves the pair leaves out
        warnings.simplefilter("ignore", UserWarning)
        mb = compile_multibook(pair, model, base_currency=CurrencyTypes.GBP)
    N = mb.basket.n_quotes
    q0 = mb.basket.quotes0
    book_pvs = make_multibook_fn(mb, device=device)(
        q0, np.zeros((1, N)))["pvs"][0].cpu().numpy()
    _reset_launches()
    lad = make_per_trade_delta_fn(mb, device)(q0).cpu().numpy() * 1e-4
    k1 = _launches()["pvs_sweep"]
    if k1 <= 0:
        raise AssertionError("the book ladders did not launch K1")
    for k, name in enumerate(("ois", "zcis")):
        e = results[name]
        _check(f"engine vs book {name} PV (abs, bound max(1e-6, 1e-10 "
               f"|PV|))", abs(book_pvs[k] - e.value.amount),
               max(1e-6, 1e-10 * abs(e.value.amount)))
        rtol, atol = (1e-9, 1e-8) if name == "ois" else (1e-8, 1e-7)
        curves = ["GBP_OIS_SONIA"] + (["GBP_RPI_INFLATION"]
                                      if name == "zcis" else [])
        for cname in curves:
            ref = e.risk(CurveTypes[cname]).risk_ladder
            got = lad[k, mb.basket.quote_slice(cname)]
            excess = float((np.abs(got - ref)
                            - (atol + rtol * np.abs(ref))).max())
            _check(f"engine vs book {name} {cname} ladder (K1 per-trade "
                   f"delta x 1e-4; worst excess over atol {atol:g} + rtol "
                   f"{rtol:g} |ref|)", max(excess, 0.0), 0.0)
    rec["book_gate_k1_launches"] = k1
    mark("engine against the book")

    # ---- a Portfolio of the route trades, one per valuation currency -----
    groups = {}
    for name, trade, c in routes:
        groups.setdefault((results[name].value.currency.name, c),
                          []).append((name, trade))
    for (ccy, c), members in groups.items():
        pf = Portfolio([t.position(model, device=device)
                        for _, t in members])
        total = pf.compute([R.VALUE], c).value.amount
        ref = sum(results[n].value.amount for n, _ in members)
        _check(f"engine Portfolio of {len(members)} {ccy} trades == sum "
               f"of their PVs (abs / max(|sum|, 1))",
               abs(total - ref) / max(abs(ref), 1.0), 1e-12)
    mark("Portfolio")
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"engine phase: {rec['phase_s']:.1f} s "
          f"({ {k: round(v, 2) for k, v in rec['parts_s'].items()} }); card "
          f"{card}", flush=True)
    return rec


def _twin_gates(name, mono, q0, shocks, chunk, pt_fns) -> dict:
    """K1, K2 and K3 against their plain twins on one book's inputs (K1 on
    the PV pass and the ladders, K2 at the staged chunk, K3 on the
    selected and the blocks path), each at 1e-12 x max|ref|; returns the
    errors. These launches are not counted on any main path."""
    from adrates_torch.ops import kernels
    from adrates_torch.parallel import multibook as tmb
    book = mono.book
    errs = {}

    def gate(key, got, ref):
        got, ref = list(got), list(ref)
        scale = max(float(r.abs().max()) for r in ref)
        errs[key] = max(float((g - r).abs().max())
                        for g, r in zip(got, ref)) / scale
        _check(f"{name} {key} vs plain (abs / max|ref|)", errs[key], 1e-12)

    vT = tmb.value_table(mono.dfs_only(q0, shocks), book.aggregate)
    gate("K1 pvs_sweep", [kernels.pvs_sweep(vT, book.sweep)],
         [kernels.pvs_sweep_plain(vT, book.sweep)])
    dfs_c, J = mono.jacobians(q0, shocks[:chunk])
    J = J.contiguous()
    gate("K2 gamma_quad_form_grouped",
         [kernels.gamma_quad_form_grouped(J, dfs_c, book.quad)],
         [kernels.gamma_quad_form_grouped_plain(J, dfs_c, book.quad)])
    del vT, J, dfs_c
    lad_fn, gam_fn, blk_fn = pt_fns
    _, _, Jv = lad_fn.prep(q0)
    tab = lad_fn.book.sweep
    gate("ladders K1 pvs_sweep (trade-major)",
         [kernels.pvs_sweep(Jv, tab, trade_major=True)],
         [kernels.pvs_sweep_plain(Jv, tab, trade_major=True)])
    del Jv
    for key, f in (("gamma_256", gam_fn), ("gamma_blocks", blk_fn)):
        _, dfs, Jt, w = f.prep(q0)
        gate(f"{key} K3 pertrade_quad_form",
             kernels.pertrade_quad_form(Jt, dfs, w, f.k3),
             kernels.pertrade_quad_form_plain(Jt, dfs, w, f.k3))
    return errs


def run_flagship_v5_splines(device, flat, flat_gam, n_warm: int = 3):
    """Phase 7d: flagship_v5 with five of its OIS curves on the fitted
    schemes (``flagship_v5.SPLINE_SCHEMES``; the book, seed and draw order
    unchanged): the staged path cold + ``n_warm`` warm with phase 7's
    gates (FD also on a GBP, a USD and a JPY quote), the generic split
    once; the engine against the book's PVs on one live OIS of each
    spline curve and one basis swap of each XCCY curve; each spline
    curve's ``df_t`` against the book's grid row; the per-trade paths;
    K1-K3 against their twins on this book; config 2 on the PCHIP GBP
    curve and a bond's analytics. ``flat`` is phase 7's info, printed
    beside this phase's, and ``flat_gam`` (phase 7b's 256-gamma info,
    with its device ops and ms) the FLAT_FWD gammas beside this book's.
    Returns (the ``splines`` record, the staged path's info with the 256
    gammas' under ``gamma_256``, K6's and K7's captured inputs for phase
    8, K8-K11's captured inputs at each XCCY stage for phase 8, K4's and
    K5's largest calls of one warm staged call for phase 8: its OIS stage
    has fitted members, so it keeps the torch.func towers over the
    bootstrap's solve)."""
    import numpy as np
    import torch

    from adrates_torch.examples import flagship_v5 as cfg
    from adrates_torch.parallel import multibook as tmb
    from adrates_torch.trades.credit import Bond
    from adrates_torch.trades.rates import OIS, XccyBasisSwap
    from adrates_torch.utils import CurrencyTypes, RequestTypes
    R = RequestTypes
    VDG = [R.VALUE, R.DELTA, R.GAMMA]
    card = _card_line()
    t_phase = time.perf_counter()
    schemes = {n: it.name for n, it in cfg.SPLINE_SCHEMES.items()}
    reach, stop_reach = _watch_reach()

    rng = np.random.default_rng(cfg.SEED)
    t0 = time.perf_counter()
    model = cfg.build_model(schemes=cfg.SPLINE_SCHEMES)
    t_model = time.perf_counter() - t0
    t0 = time.perf_counter()
    with warnings.catch_warnings():        # CHF has no trades
        warnings.simplefilter("ignore", UserWarning)
        mb, shocks = cfg.build_book(model, rng)
    t_compile = time.perf_counter() - t0
    S = cfg.N_SCENARIOS
    q0 = mb.basket.quotes0
    basket = mb.basket
    pads = {}
    for st in basket.stages:
        pm = np.asarray(basket.bat[st.key]["pad_mask"])
        for g, cid in enumerate(st.ids):
            if basket.specs[cid].name in schemes:
                pads[basket.specs[cid].name] = int(pm[g].sum())
    if sorted(pads) != sorted(schemes):
        raise AssertionError(f"spline members {sorted(pads)}")
    print(f"flagship_v5 splines: schemes {schemes} (CHF, CAD FLAT_FWD); pad "
          f"positions of each spline member in its stage {pads}", flush=True)

    fn, out, info = _run_staged(
        "flagship_v5 splines", mb, shocks, device, n_warm,
        lambda fn: _describe("flagship_v5 splines", mb, fn, S, t_model,
                             t_compile, mb.tile.base_trades))
    for name in ("pvs_sweep", "gamma_quad_form_grouped"):
        if info[name] <= 0:
            raise AssertionError(f"{name} was not launched on the spline "
                                 f"book's staged path")
    _solve_launches("flagship_v5 splines staged", info, solves=True)
    _ois_routes("flagship_v5 splines", mb)
    info["fitted_per_call"] = _fitted_launches("flagship_v5 splines staged",
                                               info)
    _call_device("flagship_v5 splines staged", fn, q0, shocks, info)
    info["regions_ms"], a = _time_regions(fn, q0, shocks, device)
    _print_regions("flagship_v5 splines", a["dfs"].shape[0],
                   info["regions_ms"])
    del a
    info["regions_device"] = _region_device(fn, q0, shocks, device)
    print("flagship_v5 splines regions on the first chunk, device ops and "
          "device ms (with the XCCY stages on torch.func, PERF.md): "
          + "; ".join(
              f"{k} {v['device_ops']} ops, {_fmt_ms(v['device_ms'])} "
              f"(torch.func {SPLINE_REGIONS_TORCH_FUNC[k][0]:,} ops, "
              f"{SPLINE_REGIONS_TORCH_FUNC[k][1]} ms)"
              for k, v in info["regions_device"].items())
          + f"; card {card}", flush=True)
    # the XCCY stages over the fitted parents take K8-K11
    routes = _xccy_routes("flagship_v5 splines", mb)
    if len(routes) != 3 or any(r != "kernels" for r in routes.values()):
        raise AssertionError(f"flagship_v5 splines: XCCY stage routes "
                             f"{routes}, expected 3 on the kernels")
    _xccy_launches("flagship_v5 splines staged", info)
    xccy_inputs = _capture_xccy(lambda: fn(q0, shocks), per_stage=True)
    if len(xccy_inputs) != 3:
        raise AssertionError(f"flagship_v5 splines: K8-K11 captured at "
                             f"{len(xccy_inputs)} XCCY stages, not 3")
    fit_inputs = _capture_fitted(fn, q0, shocks, device)
    # K4 / K5 at their largest calls of one warm staged call (regions A
    # and C2's torch.func towers over the OIS stage with fitted members)
    solve_inputs = _capture_solves(lambda: fn(q0, shocks))
    print("flagship_v5 splines K6 / K7 calls captured: "
          + ", ".join(f"{k[1]} {k[0]} {list(v[0])}"
                      for k, v in fit_inputs.items()), flush=True)
    mono = tmb.make_multibook_fn(mb, device=device)
    delta0 = out["delta"][0]
    fd = []
    for name in ("GBP_OIS_SONIA", "USD_OIS_SOFR", "JPY_OIS_TONAR"):
        sl = basket.quote_slice(name)
        fd.append(sl.start + int(delta0[sl].abs().argmax()))
    print(f"flagship_v5 splines FD probes: GBP {fd[0]}, USD {fd[1]}, JPY "
          f"{fd[2]}", flush=True)
    check_outputs("flagship_v5 splines", out, mono, q0, shocks, mb.n_trades,
                  fd_extra=tuple(fd))
    _check_staged_vs_mono("flagship_v5 splines", out, mono, q0, shocks)

    # ---- the generic split, once -----------------------------------------
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        mb_gen, _ = cfg.build_book(model, np.random.default_rng(cfg.SEED),
                                   batch_curves=False)
    fn_gen = tmb.make_multibook_fn(mb_gen, device=device)
    if fn_gen.structured:
        raise AssertionError("batch_curves=False took the structured split")
    _reset_launches()
    out_gen, info["generic_ms"] = _timed(lambda: fn_gen(q0, shocks))
    info["generic_launches"] = _launches()
    _solve_launches("flagship_v5 splines generic",
                    dict(info["generic_launches"], calls=1))
    _fitted_launches("flagship_v5 splines generic",
                     dict(info["generic_launches"], calls=1))
    print(f"flagship_v5 splines generic: one call {info['generic_ms']:.1f} "
          f"ms; launches {info['generic_launches']}", flush=True)
    for k, bound in (("pvs", 1e-10), ("delta", 1e-9), ("gamma", 1e-8)):
        _check(f"flagship_v5 splines generic vs structured {k} (abs / "
               f"max|ref|)", float((out_gen[k] - out[k]).abs().max()
                                   / out[k].abs().max()), bound)
    del out_gen, fn_gen, mb_gen, out
    torch.cuda.empty_cache()

    # ---- the book against the curves and the engine ----------------------
    dfs0 = mono.dfs_only(q0, np.zeros((1, basket.n_quotes)))[0].cpu().numpy()
    for name in schemes:
        cols = np.flatnonzero(basket.grid_curve_of == basket.curve_id(name))
        t = basket.unique_times[basket.grid_local_of[cols]]
        ref = model.curves[name].df_t(t).numpy()
        _check(f"flagship_v5 splines {name} df_t vs the book's grid row at "
               f"its {t.shape[0]} times (abs / max|ref|)",
               float(np.abs(dfs0[cols] - ref).max() / np.abs(ref).max()),
               1e-10)
    base, coll = cfg.build_base_trades(model,
                                       np.random.default_rng(cfg.SEED))
    live = [(t, c) for t, c in zip(base, coll)
            if t._maturity_dt > model.value_dt and c is None]
    picks = [next(t for t, _ in live if isinstance(t, OIS)
                  and t._floating_index.name == name) for name in schemes]
    picks += [next(t for t, _ in live if isinstance(t, XccyBasisSwap)
                   and t._foreign_floating_index.name == forn)
              for forn in ("GBP_OIS_SONIA", "EUR_OIS_ESTR", "JPY_OIS_TONAR")]
    with warnings.catch_warnings():        # curves the picks leave out
        warnings.simplefilter("ignore", UserWarning)
        mb_e = tmb.compile_multibook(picks, model,
                                     base_currency=CurrencyTypes.USD)
    book_pvs = tmb.make_multibook_fn(mb_e, device=device).pvs_only(
        mb_e.basket.quotes0, np.zeros((1, mb_e.basket.n_quotes)))[0].cpu()
    for k, t in enumerate(picks):
        v = t.position(model, device=device).compute([R.VALUE]).value
        ccy = v.currency.name
        usd = v.amount * (1.0 if ccy == "USD" else model.fx(f"{ccy}USD"))
        label = (t._floating_index.name if isinstance(t, OIS)
                 else f"basis over {t._foreign_floating_index.name}")
        _check(f"flagship_v5 splines engine vs book PV, {label} (abs, bound "
               f"max(1e-6, 1e-10 |PV|))", abs(float(book_pvs[k]) - usd),
               max(1e-6, 1e-10 * abs(usd)))
    del dfs0, mb_e, book_pvs
    print(f"flagship_v5 splines: book tied to the curves and the engine; "
          f"phase so far {time.perf_counter() - t_phase:.1f} s", flush=True)

    # ---- the per-trade paths and the kernels' twins -----------------------
    print("phase 7d per-trade paths on the spline book:", flush=True)
    pt_fns, pt_infos = run_per_trade(device, fn, mono, mb, q0, n_warm,
                                     node_route=False)
    for key in ("ladders", "gamma_256", "blocks"):
        pt_infos[key]["fitted_per_call"] = _fitted_launches(
            f"flagship_v5 splines per-trade {key}", pt_infos[key],
            reverse=key != "ladders")
    info["gamma_256"] = pt_infos["gamma_256"]
    gam_fn, fgam_info = pt_fns[1], flat_gam
    fit_inputs.update(_watch_fitted(
        [("gamma_256", lambda: gam_fn(q0))],
        [("gamma_256", k) for k in FITTED]))
    print("flagship_v5 splines 256 gammas' largest K6 / K7 calls: "
          + ", ".join(f"{k} {list(fit_inputs[('gamma_256', k)][0])}"
                      for k in FITTED), flush=True)
    g_ops, g_ms = (pt_infos["gamma_256"][k] for k in ("device_ops",
                                                     "device_ms"))
    f_ops, f_ms = fgam_info["device_ops"], fgam_info["device_ms"]
    pt_infos["gamma_256"].update(flat_device_ops=f_ops, flat_device_ms=f_ms)
    print(f"flagship_v5 splines 256 gammas vs phase 7b (FLAT_FWD): warm "
          f"median {statistics.median(pt_infos['gamma_256']['warm_ms']):.1f}"
          f" vs {statistics.median(fgam_info['warm_ms']):.1f} ms, one warm "
          f"call {g_ops} vs {f_ops} device ops, device {_fmt_ms(g_ms)} vs "
          f"{_fmt_ms(f_ms)}; K6 / K7 launches a call "
          f"{pt_infos['gamma_256']['fitted_per_call']}; card {card}",
          flush=True)
    twins = _twin_gates("flagship_v5 splines", mono, q0, shocks,
                        info["chunk"], pt_fns)
    del pt_fns, fn, mono
    torch.cuda.empty_cache()

    # ---- the engine on the PCHIP GBP curve, a bond's analytics -----------
    swap = _config2_swap(model)
    pos = swap.position(model, device=device)
    before = _launches()
    res, c2 = _drive_request(pos, VDG, 20)
    c2["launches"] = _launches_since(before, 21)
    _solve_launches("flagship_v5 splines engine config 2", c2["launches"])
    c2["device_ops"], c2["device_ms"] = _request_device(
        lambda: pos.compute(VDG))
    res_cpu, _ = _drive_request(swap.position(model, device="cpu"), VDG, 1)
    c2["cuda_vs_cpu_err"] = _cuda_vs_cpu("flagship_v5 splines config 2", res,
                                         res_cpu)
    for a in _result_arrays(res):
        if not np.isfinite(a).all():
            raise AssertionError("flagship_v5 splines config 2: non-finite")
    print(f"flagship_v5 splines config 2 (GBP_OIS_SONIA "
          f"{schemes['GBP_OIS_SONIA']}): VALUE+DELTA+GAMMA cold "
          f"{c2['cold_ms']:.1f} ms, warm median {c2['warm_ms']['median']:.2f} "
          f"[{c2['warm_ms']['min']:.2f}, {c2['warm_ms']['max']:.2f}] ms over "
          f"20; one request {c2['device_ops']} device ops, "
          f"{_fmt_ms(c2['device_ms'])}; card {card}", flush=True)
    bond = next(t for t in base if isinstance(t, Bond)
                and t._currency == CurrencyTypes.GBP
                and t._maturity_dt > model.value_dt)
    curve = model.curves.GBP_OIS_SONIA
    v = model.value_dt

    def analytics():
        return (bond.duration(v, curve),
                bond.g_spread(v, curve, bond.clean_price(v, curve)))
    (dur, gsp), bond_ms = _timed(analytics)
    if not (np.isfinite(dur) and np.isfinite(gsp) and dur > 0):
        raise AssertionError(f"bond analytics: duration {dur}, g_spread {gsp}")
    print(f"flagship_v5 splines bond analytics on the host: duration "
          f"{dur:.6f}, g_spread {gsp:.8f} in {bond_ms:.1f} ms", flush=True)

    def book_rec(i):
        return dict(warm_ms=i["warm_ms"], cold_ms=i["cold_ms"],
                    regions_ms=i["regions_ms"], device_ops=i["device_ops"],
                    device_ms=i["device_ms"], peak_gib=i["peak_gib"],
                    launches={k: i[k] for k in ("pvs_sweep",
                                                "gamma_quad_form_grouped")
                              + FITTED + XCCY})
    stop_reach()
    rec_reach = _reach_summary(reach)
    print(f"flagship_v5 splines: the farthest reach past the last knot of "
          f"the {rec_reach['plans']} static fitted plans the cell and its "
          f"engine requests built, in last intervals: splines "
          f"{rec_reach.get('spline')}, PCHIP {rec_reach.get('pchip')}",
          flush=True)
    rec = dict(card=card, schemes=schemes, pads=pads, model_ms=t_model * 1e3,
               compile_ms=t_compile * 1e3, staged=book_rec(info),
               xccy_routes=routes, regions_device=info["regions_device"],
               fitted_reach=rec_reach,
               flat_staged=book_rec(flat), generic_ms=info["generic_ms"],
               fitted_per_call=info["fitted_per_call"],
               per_trade={k: dict(warm_ms=i["warm_ms"], prep_ms=i["prep_ms"],
                                  peak_gib=i["peak_gib"],
                                  fitted_per_call=i["fitted_per_call"],
                                  **{m: i[m] for m in (
                                      "device_ops", "device_ms",
                                      "flat_device_ops", "flat_device_ms")
                                     if m in i})
                          for k, i in pt_infos.items()
                          if k in ("ladders", "gamma_256", "blocks")},
               pertrade_routes=pt_infos["routes"],
               twins=twins, config2=c2,
               bond=dict(duration=dur, g_spread=gsp, ms=bond_ms))
    rec["phase_s"] = time.perf_counter() - t_phase
    s, f = rec["staged"], rec["flat_staged"]
    print(f"flagship_v5 splines vs phase 7 (FLAT_FWD), warm staged median "
          f"{statistics.median(s['warm_ms']):.1f} vs "
          f"{statistics.median(f['warm_ms']):.1f} ms, device ops "
          f"{s['device_ops']} vs {f['device_ops']}, device "
          f"{_fmt_ms(s['device_ms'])} vs {_fmt_ms(f['device_ms'])}, peak "
          f"{s['peak_gib']:.2f} vs {f['peak_gib']:.2f} GiB; K6 / K7 "
          f"launches a call {rec['fitted_per_call']}; phase "
          f"{rec['phase_s']:.1f} s; card {card}", flush=True)
    return rec, info, fit_inputs, xccy_inputs, solve_inputs


# Single-curve book sizes of phase 7e (the quick start's 20 base OIS tiled
# to 100,000 trades; 1,000 bucketed OIS each tiled to 100,000)
BOOK_COPIES = 5_000
BUCKET_COPIES = 100


def _rel(a, b) -> float:
    return abs(a - b) / abs(b)


def _max_rel(got, ref) -> float:
    """max |got - ref| / max |ref| of two tensors or arrays."""
    import numpy as np
    got, ref = (np.asarray(x.cpu() if hasattr(x, "cpu") else x)
                for x in (got, ref))
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _warm_calls(name, f, n_warm):
    """A cold call with the launch counts from 0 and the peak memory
    reset, ``n_warm`` warm calls, the device ops and device ms of one more
    warm call; returns (out, info)."""
    import torch
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    out, cold = _timed(f)
    warm = [_timed(f)[1] for _ in range(n_warm)]
    info = dict(_launches(), calls=1 + n_warm, cold_ms=cold,
                warm_ms=_stats(warm),
                peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    n_ops, d_ms = _request_device(f)
    med = info["warm_ms"]["median"]
    info.update(device_ops=n_ops, device_ms=d_ms,
                busy_share=d_ms and d_ms / med)
    print(f"{name}: cold {cold:.1f} ms, warm median {med:.2f} "
          f"[{info['warm_ms']['min']:.2f}, {info['warm_ms']['max']:.2f}] ms "
          f"over {n_warm}; one warm call {n_ops} device ops, "
          f"{_fmt_ms(d_ms)} of device time (busy share "
          f"{'not measured' if d_ms is None else f'{d_ms / med:.3f}'}); "
          f"launches {info['pvs_sweep']} of K1 in {1 + n_warm} calls; "
          f"peak {info['peak_gib']:.2f} GiB", flush=True)
    return out, info


def run_host_api(device, model, mb_big, n_warm: int = 3, device_arg=None):
    """Phase 7e: the host API and the single-curve book on the card. The
    quick start; ``bench.py``'s config-2 delta against central FDs on
    ``model.scenario``; ``scenario_grid``; the JSON round trip and FX
    routing of ``model`` (phase 7's flagship_v5); the single-curve book
    (K1) at 100,000 trades x 100 scenarios, bucketed and not; book SPEED
    at N = 64. Calls that take a device get ``device_arg`` (None: the
    card). ``mb_big`` is phase 7's multibook (N = 184), which the SPEED
    guard refuses. Returns (the ``hostapi`` record, the book path's
    (fn, rates, book, shocks, info) for phase 8)."""
    import numpy as np
    import torch

    from adrates_torch.examples import flagship_ois, quickstart
    from adrates_torch.models import Model
    from adrates_torch.ops import kernels
    from adrates_torch.parallel import (aggregate_book, aggregate_total_pv,
                                        compile_book, compile_book_buckets,
                                        compile_multibook, make_book_fn,
                                        make_bucketed_book_fn,
                                        make_multibook_fn,
                                        make_multibook_speed_fn,
                                        merge_aggregates, tile_book)
    from adrates_torch.trades.rates import OIS
    from adrates_torch.utils import (BusDayAdjustTypes, CurrencyTypes,
                                     CurveTypes, DayCountTypes,
                                     FrequencyTypes, InterpTypes, LibError,
                                     RequestTypes, SwapTypes)
    R = RequestTypes
    card = _card_line()
    rec = dict(card=card, parts_s={})
    t_phase = t_mark = time.perf_counter()

    def mark(part):
        nonlocal t_mark
        now = time.perf_counter()
        rec["parts_s"][part] = now - t_mark
        t_mark = now

    # ---- the quick start -------------------------------------------------
    _reset_launches()
    qs, ms = _timed(lambda: quickstart.main(device_arg))
    for k in ("book_pv_sums", "book_delta", "book_gamma"):
        if not np.isfinite(qs[k]).all():
            raise AssertionError(f"quick start {k}: non-finite")
    e1 = abs(qs["pnl_order1"] - qs["pnl_100bp"])
    e2 = abs(qs["pnl_order2"] - qs["pnl_100bp"])
    print(f"quick start on the card: 10Y PV {qs['pv_10y']:.6f} GBP; +100 bp "
          f"P&L {qs['pnl_100bp']:.2f} GBP, first order {qs['pnl_order1']:.2f}"
          f" (off {e1:.2f}), first + second {qs['pnl_order2']:.2f} (off "
          f"{e2:.2f}); book {qs['book_trades']} trades; {ms:.0f} ms; "
          f"launches {_launches()}", flush=True)
    _check("quick start: second-order P&L error / first-order's", e2 / e1,
           1.0 - 1e-12)
    _solve_launches("quick start", dict(_launches(), calls=1))
    rec["quick_start"] = dict(
        pv_10y=qs["pv_10y"], pnl_100bp=float(qs["pnl_100bp"]),
        pnl_order1=qs["pnl_order1"], pnl_order2=qs["pnl_order2"],
        book_pv_sum=float(qs["book_pv_sums"].sum()), ms=ms,
        k1_launches=_launches()["pvs_sweep"])
    mark("quick start")

    # ---- config 2's delta against FDs on model.scenario ------------------
    swap = _config2_swap(model)
    tenors = model._curve_params_dict["GBP_OIS_SONIA"]["tenor_list"]
    res = swap.position(model, device=device).compute([R.VALUE, R.DELTA])
    lad = res.risk.risk_ladder
    top = float(np.abs(lad).max())
    fd_rec = {}
    # the swap is at par on the curve's own 10Y quote, so its other
    # buckets are ~0: each is held to 1e-5 of the largest bucket
    for i in np.argsort(-np.abs(lad))[:3]:
        pv = [swap.position(model.scenario("GBP_OIS_SONIA",
                                           {tenors[i]: h}),
                            device=device).compute([R.VALUE]).value.amount
              for h in (0.01, -0.01)]          # +-1 bp, quotes in percent
        fd = (pv[0] - pv[1]) / 2.0
        _check(f"config 2 DELTA at {tenors[i]} ({float(lad[i]):.6g}) vs "
               f"central FD of VALUE on model.scenario +-1bp ({fd:.6g}), "
               f"abs / max|DELTA|", abs(float(lad[i]) - fd) / top, 1e-5)
        fd_rec[tenors[i]] = [float(lad[i]), fd]
    rec["scenario_fd"] = fd_rec
    mark("scenario FD")

    # ---- scenario_grid ---------------------------------------------------
    sg_shocks = np.random.default_rng(7).normal(0.0, 0.1, (100, len(tenors)))
    grid, sg = _warm_calls(
        "scenario_grid GBP_OIS_SONIA S=100",
        lambda: model.scenario_grid("GBP_OIS_SONIA", sg_shocks,
                                    device=device_arg), n_warm)
    for s in (0, 49, 99):
        ref = model.scenario("GBP_OIS_SONIA", dict(
            zip(tenors, sg_shocks[s]))).curves.GBP_OIS_SONIA._dfs
        _check(f"scenario_grid row {s} vs model.scenario DFs (abs)",
               float((grid[s].cpu() - ref).abs().max()), 1e-12)
    sg["shape"] = list(grid.shape)
    _solve_launches("scenario_grid", sg, reverse=False)
    rec["scenario_grid"] = sg
    mark("scenario_grid")

    # ---- JSON and FX -----------------------------------------------------
    t0 = time.perf_counter()
    text = model.to_json()
    t1 = time.perf_counter()
    back = Model.from_json(text)
    t2 = time.perf_counter()
    for name in model.curves.keys():
        if not torch.equal(back.curves[name]._dfs, model.curves[name]._dfs):
            raise AssertionError(f"JSON round trip: {name}'s DFs differ")
    pv0 = swap.position(model, device=device).compute([R.VALUE]).value.amount
    pv1 = swap.position(back, device=device).compute([R.VALUE]).value.amount
    if pv0 != pv1:
        raise AssertionError(f"JSON round trip: config-2 PV {pv1!r} != "
                             f"{pv0!r}")
    fx = {}
    for pair in ("GBPJPY", "EURCHF"):
        cross = model.fx(pair[:3] + "USD") / model.fx(pair[3:] + "USD")
        fx[pair] = model.fx(pair)
        _check(f"Model.fx({pair}) vs the USD cross (rel)",
               _rel(fx[pair], cross), 1e-15)
    try:
        model.fx("GBPNZD")
    except LibError as e:
        fx["GBPNZD"] = str(e)
    else:
        raise AssertionError("Model.fx(GBPNZD) did not raise")
    rec["json_fx"] = dict(to_json_ms=(t1 - t0) * 1e3,
                          from_json_ms=(t2 - t1) * 1e3, chars=len(text),
                          curves=len(model.curves.keys()), fx=fx)
    print(f"JSON: {len(text)} chars, to_json {(t1 - t0) * 1e3:.1f} ms, "
          f"from_json (12 curves rebuilt) {(t2 - t1) * 1e3:.0f} ms; every "
          f"curve's DFs and the config-2 PV bit-identical; fx {fx}",
          flush=True)
    mark("JSON and FX")

    # ---- the single-curve book at full width -----------------------------
    curve = model.curves.GBP_OIS_SONIA
    q = np.asarray(curve.swap_rates)
    N = q.shape[0]
    base_swaps = quickstart.book_swaps(np.random.default_rng(0))
    base = compile_book(base_swaps, model.value_dt)
    rng = np.random.default_rng(7)
    cs = rng.uniform(0.5, 1.5, BOOK_COPIES)
    ns = rng.uniform(0.5, 1.5, BOOK_COPIES)
    book = tile_book(base, BOOK_COPIES, coupon_scale=cs, notional_scale=ns)
    agg = aggregate_book(book)
    shocks = rng.normal(0.0, 1e-3, (100, N))
    fn = make_book_fn(curve._plan, curve._interp_type, device=device_arg)
    k_build = kernels.build_kernels()
    torch.cuda.synchronize()
    tab, tab_ms = _timed(lambda: fn.tables(book))
    out, info = _warm_calls(
        f"single-curve book {book.num_trades} trades x 100 scenarios",
        lambda: fn(q, book, agg, shocks), n_warm)
    info.update(kernel_build_s=k_build, tables_ms=tab_ms,
                trades=book.num_trades, U=int(book.unique_times.shape[0]),
                T=int(tab.trip_s.shape[0]), slots=int(tab.sweep.slot_w.numel()),
                launches_per_call=info["pvs_sweep"] / info["calls"])
    if info["pvs_sweep"] != info["calls"]:
        raise AssertionError(f"make_book_fn launched K1 {info['pvs_sweep']} "
                             f"times in {info['calls']} calls")
    _solve_launches("single-curve book", info)
    pvs, delta, gamma = (out[k].cpu().numpy()
                         for k in ("pvs", "delta", "gamma"))
    for k, a in (("pvs", pvs), ("delta", delta), ("gamma", gamma)):
        if not np.isfinite(a).all():
            raise AssertionError(f"single-curve book {k}: non-finite")
    rt = torch.as_tensor(q, device=device)
    sh = torch.as_tensor(shocks, device=device)
    totals = np.array([float(aggregate_total_pv(rt + sh[s], curve._plan,
                                                curve._interp_type, agg))
                       for s in range(shocks.shape[0])])
    _check("single-curve book sum of trade PVs vs aggregate_total_pv, worst "
           "scenario (rel)", float(np.max(np.abs(pvs.sum(1) - totals)
                                          / np.abs(totals))), 1e-9)
    j = int(np.abs(delta[0]).argmax())
    h = 1e-5
    e = torch.zeros(N, dtype=torch.float64, device=device)
    e[j] = h
    fd = (float(aggregate_total_pv(rt + sh[0] + e, curve._plan,
                                   curve._interp_type, agg))
          - float(aggregate_total_pv(rt + sh[0] - e, curve._plan,
                                     curve._interp_type, agg))) / (2 * h)
    _check(f"single-curve book delta at {tenors[j]} (scenario 0) vs central "
           f"FD of aggregate_total_pv (rel)", _rel(float(delta[0, j]), fd),
           1e-5)
    _check("single-curve book gamma symmetric (abs / max|gamma|)",
           float(np.abs(gamma - gamma.transpose(0, 2, 1)).max()
                 / np.abs(gamma).max()), 1e-10)
    vT, _ = fn.value_table(rt, book, sh)
    _check("single-curve book K1 vs plain on its inputs (abs / max|ref|)",
           _max_rel(kernels.pvs_sweep(vT, tab.sweep),
                    kernels.pvs_sweep_plain(vT, tab.sweep)), 1e-12)
    del vT
    # the untiled base book against make_multibook_fn on the same trades
    # compiled as a one-curve multibook
    base_out = make_book_fn(curve._plan, curve._interp_type,
                            device=device)(q, base, aggregate_book(base),
                                           shocks)
    mb1 = compile_multibook(base_swaps, model, base_currency=CurrencyTypes.GBP,
                            curve_names=["GBP_OIS_SONIA"])
    mb_out = make_multibook_fn(mb1, device)(mb1.basket.quotes0, shocks)
    for k in ("delta", "gamma"):
        _check(f"single-curve base book {k} vs make_multibook_fn's on the "
               f"one-curve multibook (abs / max|ref|)",
               _max_rel(base_out[k], mb_out[k]), 1e-9)
    info.update(delta_fd=[tenors[j], float(delta[0, j]), fd])
    rec["book"] = info
    print(f"single-curve book: U={info['U']}, T={info['T']}, "
          f"{info['slots']} K1 slots, tables built in {tab_ms:.1f} ms "
          f"(kernel build in this process {k_build:.3f} s); card {card}",
          flush=True)
    book_args = (fn, rt, book, sh, info)
    del out, base_out, mb_out
    mark("single-curve book")

    # ---- the bucketed book -----------------------------------------------
    rng = np.random.default_rng(7)
    years = rng.integers(1, 51, 1000)
    swaps = [OIS(model.value_dt, f"{n}Y",
                 SwapTypes.PAY if i % 2 else SwapTypes.RECEIVE,
                 float(rng.uniform(0.02, 0.05)), FrequencyTypes.ANNUAL,
                 DayCountTypes.ACT_365F, CurveTypes.GBP_OIS_SONIA,
                 CurrencyTypes.GBP, notional=1e6,
                 float_dc_type=DayCountTypes.ACT_365F,
                 bd_type=BusDayAdjustTypes.MODIFIED_FOLLOWING)
             for i, n in enumerate(years)]
    buckets, order = compile_book_buckets(swaps, model.value_dt, n_buckets=4)
    tiled = [tile_book(b, BUCKET_COPIES) for b in buckets]
    bagg = merge_aggregates([aggregate_book(b) for b in tiled])
    mono = tile_book(compile_book(swaps, model.value_dt), BUCKET_COPIES)
    magg = aggregate_book(mono)
    for k in ("trip_s", "trip_e", "trip_p"):
        if not np.array_equal(getattr(bagg, k), getattr(magg, k)):
            raise AssertionError(f"bucketed aggregate {k} differs")
    _check("bucketed merge_aggregates vs aggregate_book of the monolithic "
           "tiled book (abs / max|ref|)",
           max(_max_rel(bagg.w_lin, magg.w_lin),
               _max_rel(bagg.trip_w, magg.trip_w)), 1e-12)
    bfn = make_bucketed_book_fn(curve._plan, curve._interp_type,
                                device=device_arg)
    bfn.tables(tiled)
    bout, binfo = _warm_calls(
        f"bucketed book {sum(b.num_trades for b in tiled)} trades in "
        f"{len(tiled)} buckets x 100 scenarios",
        lambda: bfn(q, tiled, bagg, shocks), n_warm)
    mfn = make_book_fn(curve._plan, curve._interp_type, device=device)
    mout = mfn(q, mono, magg, shocks)
    # bucket k's trade c * n_k + i is monolithic trade c * 1000 + order[i]
    perm, lo = [], 0
    for b in buckets:
        n_k = b.num_trades
        perm += [c * len(swaps) + order[lo:lo + n_k]
                 for c in range(BUCKET_COPIES)]
        lo += n_k
    perm = np.concatenate(perm)
    _check("bucketed PVs vs make_book_fn's permuted by order (abs / "
           "max|ref|)", _max_rel(bout["pvs"], mout["pvs"][:, perm]), 1e-12)
    for k in ("delta", "gamma"):
        _check(f"bucketed {k} vs the monolithic book's (abs / max|ref|)",
               _max_rel(bout[k], mout[k]), 1e-12)
    binfo.update(buckets=[b.num_trades for b in tiled],
                 pads=[int(b.fix_idx.shape[1]) for b in tiled],
                 launches_per_call=binfo["pvs_sweep"] / binfo["calls"])
    if binfo["pvs_sweep"] != binfo["calls"]:
        raise AssertionError("make_bucketed_book_fn did not launch K1 once "
                             "a call")
    _solve_launches("bucketed book", binfo)
    rec["bucketed"] = binfo
    del bout, mout, mono, tiled
    mark("bucketed book")

    # ---- book SPEED at N = 64 --------------------------------------------
    m2 = Model(model.value_dt)
    main = flagship_ois.MAIN_RATES
    for name, px, dc in (("GBP_OIS_SONIA", main, DayCountTypes.ACT_365F),
                         ("USD_OIS_SOFR", [r + 0.35 for r in main],
                          DayCountTypes.ACT_360)):
        m2.build_curve(name, px_list=px, tenor_list=flagship_ois.MAIN_TENORS,
                       fixed_dcc_type=dc, float_dc_type=dc,
                       interp_type=InterpTypes.FLAT_FWD_RATES)
    m2.build_fx(["GBPUSD"], [1.27])
    trades = [t for t in flagship_ois.build_ois_trades(
        model, np.random.default_rng(flagship_ois.SEED))
        if t._floating_index.name in m2.curves]
    mb2 = compile_multibook(trades, m2, base_currency=CurrencyTypes.USD)
    N2 = mb2.basket.n_quotes
    q2 = mb2.basket.quotes0
    speed_fn = make_multibook_speed_fn(mb2, device_arg)
    speed, sinfo = _warm_calls(f"book SPEED N={N2}, {len(trades)} trades",
                               lambda: speed_fn(q2), n_warm)
    _solve_launches("book SPEED", sinfo)
    speed = speed.cpu().numpy()
    if speed.shape != (N2, N2, N2) or N2 != 64:
        raise AssertionError(f"SPEED shape {speed.shape}, N {N2}")
    if not np.isfinite(speed).all():
        raise AssertionError("SPEED: non-finite")
    scale = np.abs(speed).max() + 1.0
    for axes in ((0, 1), (1, 2)):
        d = np.abs(speed - np.swapaxes(speed, *axes))
        excess = float((d - (1e-12 * scale + 1e-9 * np.abs(speed))).max())
        _check(f"SPEED symmetric under the {axes} swap (worst excess over "
               f"atol 1e-12 x scale + rtol 1e-9)", max(excess, 0.0), 0.0)
    gfn = make_multibook_fn(mb2, device)
    for k in (1, N2 - 2):
        sh2 = np.zeros((2, N2))
        sh2[0, k], sh2[1, k] = 1e-5, -1e-5
        g = gfn(q2, sh2)["gamma"].cpu().numpy()
        fd = (g[0] - g[1]) / 2e-5
        excess = float((np.abs(speed[:, :, k] - fd)
                        - (1e-6 * scale + 5e-4 * np.abs(fd))).max())
        _check(f"SPEED[:, :, {k}] vs central FD of make_multibook_fn's "
               f"gamma (worst excess over atol 1e-6 x scale + rtol 5e-4)",
               max(excess, 0.0), 0.0)
    try:
        make_multibook_speed_fn(mb_big, device_arg)
    except LibError:
        pass
    else:
        raise AssertionError("make_multibook_speed_fn did not refuse "
                             f"N = {mb_big.basket.n_quotes}")
    sinfo.update(n_quotes=N2, trades=len(trades), max_abs=float(scale - 1.0),
                 refused_n=mb_big.basket.n_quotes)
    rec["speed"] = sinfo
    mark("book SPEED")
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"host API phase: {rec['phase_s']:.1f} s "
          f"({ {k: round(v, 2) for k, v in rec['parts_s'].items()} }); card "
          f"{card}", flush=True)
    return rec, book_args


def _table_rows(text: str) -> int:
    """The data rows (``| 1 | ...``) of captured ``print_*`` tables."""
    return sum(line.startswith("| ") and line[2:3].isdigit()
               for line in text.splitlines())


def run_ois_analytics(device, model, basis, n_warm: int = 20):
    """Phase 7g: the OIS host analytics and the print tables (no kernel).
    ``bench.py``'s config-2 OIS on phase 7's flagship_v5 GBP_OIS_SONIA:
    ``pv01``, ``ir01`` and ``swap_rate`` cold + ``n_warm`` warm on the
    host clock, beside the engine's DELTA ladder sum (not gated: ``ir01``
    is a parallel forward shift, not a par-quote ladder); gates: the OIS
    struck at c* = 100 |swap_rate| (the reference's convention: float PV
    / pv01 / notional is -c*/100 receiving fixed) prices to |VALUE| <=
    1e-8 x notional on the card, VALUE(c + 1bp) - VALUE(c) on the card
    equals pv01 x notional x 1e-6 to 1e-9 rel, and the OIS's three and
    ``basis``'s (a live base XCCY basis swap of phase 7) two print
    tables are non-empty with one row per payment. Returns the
    ``analytics`` record."""
    import contextlib
    import io

    from adrates_torch.utils import RequestTypes
    R = RequestTypes
    card = _card_line()
    t_phase = time.perf_counter()
    v, curve = model.value_dt, model.curves.GBP_OIS_SONIA
    swap = _config2_swap(model)
    notional = swap._notional
    rec = dict(card=card)
    _reset_launches()
    for name, f in (("pv01", lambda: swap.pv01(v, curve)),
                    ("ir01", lambda: swap.ir01(v, curve)),
                    ("swap_rate", lambda: swap.swap_rate(v, curve))):
        out, cold = _timed(f)
        out = float(out)
        warm = [_timed(f)[1] for _ in range(n_warm)]
        rec[name] = dict(value=out, cold_ms=cold, warm_ms=_stats(warm))
        print(f"analytics {name} of config 2 (flagship_v5 GBP_OIS_SONIA, "
              f"10Y RECEIVE 0.0387, 10M): {out!r}; cold {cold:.2f} ms, "
              f"warm median {rec[name]['warm_ms']['median']:.2f} "
              f"[{min(warm):.2f}, {max(warm):.2f}] ms over {n_warm}; card "
              f"{card}", flush=True)

    def value(s):
        return s.position(model, device=device).compute(
            [R.VALUE]).value.amount

    res = swap.position(model, device=device).compute([R.VALUE, R.DELTA])
    rec["delta_ladder_sum"] = float(res.risk.risk_ladder.sum())
    print(f"analytics ir01 {rec['ir01']['value']:.6f} beside the engine's "
          f"DELTA ladder sum {rec['delta_ladder_sum']:.6f} (per bp; not "
          f"gated: a parallel forward shift is not a par-quote ladder); "
          f"card {card}", flush=True)

    pv01, rate = rec["pv01"]["value"], rec["swap_rate"]["value"]
    c_star = 100.0 * abs(rate)
    pv_par = value(_config2_swap(model, c_star))
    rec["par"] = dict(c_star=c_star, value=pv_par)
    _check(f"analytics OIS at c* = 100 |swap_rate| = {c_star:.10f}: |VALUE| "
           f"on the card / notional", abs(pv_par) / notional, 1e-8)
    v0 = res.value.amount
    v1 = value(_config2_swap(model, swap._fixed_coupon + 1e-4))
    step, want = v1 - v0, pv01 * notional * 1e-6
    rec["coupon_bp"] = dict(value_step=step, pv01_step=want)
    _check("analytics VALUE(c + 1bp) - VALUE(c) on the card vs pv01 x "
           "notional x 1e-6 (rel)", abs(abs(step) - want) / want, 1e-9)

    swap.value(v, curve)
    _direct_value(model, basis, None)
    fixed, flt = swap._fixed_leg, swap._float_leg
    legs = (basis._domestic_leg, basis._foreign_leg)
    rows = {}
    for name, f, n in (
            ("ois print_payments", swap.print_payments,
             len(fixed._payment_dts) + len(flt._payment_dts)),
            ("ois print_fixed_leg_pv", swap.print_fixed_leg_pv,
             len(fixed._payment_dts)),
            ("ois print_float_leg_pv", swap.print_float_leg_pv,
             len(flt._payment_dts)),
            ("basis print_payments", basis.print_payments,
             sum(len(leg._payment_dts) for leg in legs)),
            ("basis print_valuation", basis.print_valuation,
             sum(len(leg._payment_dts) for leg in legs))):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            f()
        rows[name] = _table_rows(buf.getvalue())
        if not 0 < rows[name] == n:
            raise AssertionError(f"analytics {name}: {rows[name]} table "
                                 f"rows for {n} payments")
    rec["table_rows"] = rows
    launched = {k: n for k, n in _launches().items() if n}
    if set(launched) - {"pv01_solve", "pv01_solve_t"} \
            or not launched.get("pv01_solve"):
        raise AssertionError(f"analytics launched {launched}: K4 (its "
                             f"card requests' bootstraps) and no K1-K3 "
                             f"expected")
    rec["launches"] = launched
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 7g: every gate green; tables {rows} rows (one per "
          f"payment); {rec['phase_s']:.1f} s; card {card}", flush=True)
    return rec


# ---------------------------------------------------------------------------
# phase 7f: the sharded paths and the f32 ladders
# ---------------------------------------------------------------------------

# ranks of phase 7f-b, all on the one card, and their scenarios
SHARDED_WORLD = 3
SHARDED_SCEN = 10
SHARDED_NOTE = ("world 3 runs three processes that share one card over "
                "gloo: its times are not a scaling figure; no second card "
                "was available, so no multi-GPU speed-up is measured")


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _gate_rel(name, got, ref, rel):
    """max |got - ref| / max |ref| of two tensors, as a gate."""
    _check(name, _max_rel(got, ref), rel)


def _gate_totals(name, got, ref, rel=1e-12):
    """The worst scenario's |got - ref| / |ref| of two [S] totals."""
    _check(name, float(((got - ref).abs() / ref.abs()).max()), rel)


def _gate_blocks(name, got, ref, rel):
    """Two lists of GammaBlockGroups: the same groups and trades, the
    blocks at rel x max|ref| (the worst group)."""
    import numpy as np
    if len(got) != len(ref):
        raise AssertionError(f"{name}: {len(got)} groups vs {len(ref)}")
    for g, r in zip(got, ref):
        if g.cids != r.cids or not np.array_equal(g.trade_ids, r.trade_ids):
            raise AssertionError(f"{name}: group {r.cids} differs")
    _check(name, max(_max_rel(g.blocks, r.blocks) for g, r in zip(got, ref)),
           rel)


def _sharded_book(model, copies, n_scen):
    """(curve, tiled book, shocks): phase 7e's single-curve book (the
    quick start's 20 OIS, per-copy coupon and notional scales) at
    ``copies`` copies and ``n_scen`` scenarios, from the same seeds."""
    import numpy as np

    from adrates_torch.examples import quickstart
    from adrates_torch.parallel import compile_book, tile_book
    curve = model.curves.GBP_OIS_SONIA
    base = compile_book(quickstart.book_swaps(np.random.default_rng(0)),
                        model.value_dt)
    rng = np.random.default_rng(7)
    cs = rng.uniform(0.5, 1.5, copies)
    ns = rng.uniform(0.5, 1.5, copies)
    book = tile_book(base, copies, coupon_scale=cs, notional_scale=ns)
    shocks = rng.normal(0.0, 1e-3, (n_scen, len(curve.swap_rates)))
    return curve, book, shocks


def _sharded_fns(mesh, mb, sel, curve, book, device):
    """Every sharded function of the port on ``mesh``: (name, fn) pairs,
    built in this order (their build ms in the second dict)."""
    import torch

    from adrates_torch.parallel import (
        aggregate_book, make_pershard_aggregate_fn, make_sharded_book_fn,
        make_sharded_multibook_fn, make_sharded_per_trade_delta_fn,
        make_sharded_per_trade_gamma_blocks_fn,
        make_sharded_per_trade_gamma_fn, shard_book)
    builds = {}

    def built(name, make):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f = make()
        torch.cuda.synchronize()
        builds[name] = (time.perf_counter() - t0) * 1e3
        return f

    shard = shard_book(book, mesh)
    agg = aggregate_book(shard)
    q = curve.swap_rates
    fns = dict(
        multibook=built("multibook", lambda: make_sharded_multibook_fn(
            mb, mesh, device=device)),
        ladders=built("ladders", lambda: make_sharded_per_trade_delta_fn(
            mb, mesh, device=device)),
        gamma_256=built("gamma_256", lambda: make_sharded_per_trade_gamma_fn(
            mb, mesh, sel, device=device)),
        blocks=built("blocks", lambda: make_sharded_per_trade_gamma_blocks_fn(
            mb, mesh, device=device)),
        book=built("book", lambda: make_sharded_book_fn(
            curve._plan, curve._interp_type, mesh, device=device)),
        pershard=built("pershard", lambda: make_pershard_aggregate_fn(
            curve._plan, curve._interp_type, mesh, device=device)))
    calls = dict(
        multibook=lambda q0, sh: fns["multibook"](q0, sh),
        ladders=lambda q0, sh: fns["ladders"](q0),
        gamma_256=lambda q0, sh: fns["gamma_256"](q0),
        blocks=lambda q0, sh: fns["blocks"](q0),
        book=lambda q0, sh: fns["book"](q, shard, sh),
        pershard=lambda q0, sh: fns["pershard"](q, agg, sh))
    return fns, calls, builds, shard


# the K1 / K3 launches a call of each sharded function makes on a rank
SHARDED_LAUNCHES = dict(multibook=("pvs_sweep", 1), ladders=("pvs_sweep", 1),
                        gamma_256=("pertrade_quad_form", 1),
                        blocks=("pertrade_quad_form", 1),
                        book=("pvs_sweep", 1), pershard=("pvs_sweep", 0))


def _check_launches(name, info, where):
    kernel, per_call = SHARDED_LAUNCHES[name]
    if info[kernel] != per_call * info["calls"]:
        raise AssertionError(f"{where} {name}: {kernel} launched "
                             f"{info[kernel]} times in {info['calls']} "
                             f"calls, expected {per_call} a call")
    _solve_launches(f"{where} {name}", info, reverse=name != "ladders")


def _sharded_gates(where, outs, refs, sel_n, tol_book):
    """Phase 7f's gates of the sharded outputs ``outs`` (gathered where
    sharded) against the single-device ``refs``."""
    m, r = outs["multibook"], refs["multibook"]
    _gate_totals(f"{where} sharded multibook total_pv vs single device "
                 f"(rel, worst scenario)", m["total_pv"], r["total_pv"])
    for k in ("delta", "gamma"):
        _gate_rel(f"{where} sharded multibook {k} vs single device (abs / "
                  f"max|ref|)", m[k], r[k], 1e-10)
    lad = outs["ladders"]
    n = refs["ladders"].shape[0]
    if bool(lad[n:].any()):
        raise AssertionError(f"{where}: the ladders' dead rows are not zero")
    _gate_rel(f"{where} sharded ladders vs single device (abs / max|ref|)",
              lad[:n], refs["ladders"], 1e-12)
    if outs["gamma_256"].shape[0] != sel_n:
        raise AssertionError(f"{where}: {outs['gamma_256'].shape[0]} gammas")
    _gate_rel(f"{where} sharded 256 gammas vs single device (abs / "
              f"max|ref|)", outs["gamma_256"], refs["gamma_256"], 1e-12)
    _gate_blocks(f"{where} sharded gamma blocks vs single device (abs / "
                 f"max|ref|, worst group)", outs["blocks"], refs["blocks"],
                 1e-12)
    for name in ("book", "pershard"):
        o, b = outs[name], refs["book"]
        _gate_totals(f"{where} sharded {name} total_pv vs make_book_fn's "
                     f"(rel, worst scenario)", o["total_pv"], b["total_pv"],
                     tol_book)
        for k in ("delta", "gamma"):
            _gate_rel(f"{where} sharded {name} {k} vs make_book_fn's (abs / "
                      f"max|ref|)", o[k], b[k], tol_book)


def _book_ref(curve, book, shocks, device):
    from adrates_torch.parallel import aggregate_book, make_book_fn
    out = make_book_fn(curve._plan, curve._interp_type, device=device)(
        curve.swap_rates, book, aggregate_book(book), shocks)
    return dict(total_pv=out["pvs"].sum(dim=1), delta=out["delta"],
                gamma=out["gamma"])


def _world3_rank(rank, world, n_scen, copies):
    """Phase 7f-b, one rank (spawned; the group on gloo over a file store,
    every rank on the one card): flagship_v5 at ``n_scen`` scenarios and
    the single-curve book at ``copies`` copies built from their seeds,
    every sharded function called twice (cold, warm) with its launches;
    rank 0 gathers the shards and holds them to the single-device results
    it computes itself. Returns the rank's times, launches and shard."""
    import numpy as np
    import torch

    from adrates_torch.examples import flagship_v5 as cfg
    from adrates_torch.parallel import (distributed, make_multibook_fn,
                                        make_per_trade_delta_fn,
                                        make_per_trade_gamma_blocks_fn,
                                        make_per_trade_gamma_fn)
    device = torch.device("cuda", 0)
    mesh = distributed.book_mesh()
    t0 = time.perf_counter()
    model = cfg.build_model()
    with warnings.catch_warnings():        # CHF has no trades
        warnings.simplefilter("ignore", UserWarning)
        mb, shocks = cfg.build_book(model, np.random.default_rng(cfg.SEED))
    shocks = shocks[:n_scen]
    q0 = mb.basket.quotes0
    sel = _select_trades(mb)[0]
    curve, book, bshocks = _sharded_book(model, copies, n_scen)
    setup_s = time.perf_counter() - t0
    fns, calls, builds, bshard = _sharded_fns(mesh, mb, sel, curve, book,
                                              device)
    rec = dict(rank=rank, setup_s=setup_s, build_ms=builds, calls={},
               trades=dict(multibook=[fns["multibook"].shard.lo,
                                      fns["multibook"].shard.hi],
                           book=bshard.num_trades))
    outs = {}
    for name, f in calls.items():
        sh = bshocks if name in ("book", "pershard") else shocks
        _reset_launches()
        out, cold = _timed(lambda: f(q0, sh))
        out, warm = _timed(lambda: f(q0, sh))
        info = dict(_launches(), calls=2, cold_ms=cold, warm_ms=warm)
        _check_launches(name, info, f"world {world} rank {rank}")
        rec["calls"][name] = info
        outs[name] = out
    # the shards gathered on every rank (collectives), compared on rank 0
    outs["ladders"] = fns["ladders"].gather(outs["ladders"])
    outs["gamma_256"] = fns["gamma_256"].gather(outs["gamma_256"])
    outs["blocks"] = fns["blocks"].gather(outs["blocks"])
    if rank == 0:
        mono = make_multibook_fn(mb, device)(q0, shocks)
        refs = dict(
            multibook=dict(total_pv=mono["pvs"].sum(dim=1),
                           delta=mono["delta"], gamma=mono["gamma"]),
            ladders=make_per_trade_delta_fn(mb, device)(q0),
            gamma_256=make_per_trade_gamma_fn(mb, sel, device)(q0),
            blocks=make_per_trade_gamma_blocks_fn(mb, device)(q0),
            book=_book_ref(curve, book, bshocks, device))
        _sharded_gates(f"world {world} (gloo)", outs, refs, len(sel), 1e-9)
        rec["gates"] = "green"
    torch.cuda.synchronize()
    return rec


def run_sharded(device, mb, q0, shocks, ref7, pt_fns, model, single,
                n_warm: int = 3):
    """Phase 7f-a/b: (a) world 1 on NCCL in this process at full width:
    every sharded function cold + ``n_warm`` warm on phase 7's
    flagship_v5 (S = 100) and phase 7e's single-curve book, held to
    phases 7 (``ref7``), 7b (``pt_fns``) and 7e; (b) world
    ``SHARDED_WORLD`` on the one card over gloo in spawned ranks
    (flagship_v5 at ``SHARDED_SCEN`` scenarios, the single-curve book at
    whole copies per rank), rank 0 holding the gathered shards to its
    own single-device results. ``single`` holds the single-device warm
    medians of phases 7, 7b and 7e. Returns the ``sharded`` record."""
    import torch
    import torch.distributed as tdist

    from adrates_torch.parallel import distributed
    card = _card_line()
    rec = dict(card=card, count=torch.cuda.device_count(), note=SHARDED_NOTE,
               single_device_warm_ms=single)
    t_phase = time.perf_counter()
    lad_fn, gam_fn, blk_fn = pt_fns
    sel = _select_trades(mb)[0]

    # ---- 7f-a: world 1 on NCCL ------------------------------------------
    port = _free_port()
    multi = distributed.init_distributed(address=f"127.0.0.1:{port}",
                                         world_size=1, rank=0,
                                         backend="nccl")
    if not (tdist.is_initialized() and tdist.get_world_size() == 1):
        raise AssertionError("init_distributed made no process group of "
                             "one rank")
    if multi is not False:
        raise AssertionError(f"init_distributed returned {multi!r} at world "
                             f"1 (False: one process, as the JAX function)")
    try:
        mesh = distributed.book_mesh()
        curve, book, bshocks = _sharded_book(model, BOOK_COPIES,
                                             shocks.shape[0])
        fns, calls, builds, _ = _sharded_fns(mesh, mb, sel, curve, book,
                                             device)
        w1 = dict(backend="nccl", world_size=1,
                  mesh=list(mesh.mesh_dim_names), build_ms=builds, calls={})
        outs = {}
        for name, f in calls.items():
            sh = bshocks if name in ("book", "pershard") else shocks
            out, info = _drive(f"sharded {name} (world 1, nccl)", f, q0, sh,
                               n_warm)
            _check_launches(name, info, "world 1")
            info["warm_median_ms"] = statistics.median(info["warm_ms"])
            w1["calls"][name] = info
            outs[name] = out
        for name in ("ladders", "gamma_256", "blocks"):
            outs[name] = fns[name].gather(outs[name])
        refs = dict(multibook=ref7, ladders=lad_fn(q0),
                    gamma_256=gam_fn(q0), blocks=blk_fn(q0),
                    book=_book_ref(curve, book, bshocks, device))
        _sharded_gates("world 1 (nccl)", outs, refs, len(sel), 1e-9)
        del outs, refs, fns, calls
    finally:
        tdist.destroy_process_group()
    torch.cuda.empty_cache()
    rec["world_1"] = w1
    for name, info in w1["calls"].items():
        print(f"sharded {name} world 1: warm median "
              f"{info['warm_median_ms']:.1f} ms (single device "
              f"{single.get(name, 'n/a')}); card {card}", flush=True)
    print(f"phase 7f-a (world 1, nccl): every gate green; "
          f"{time.perf_counter() - t_phase:.1f} s so far", flush=True)

    # ---- 7f-b: world 3 on the one card over gloo -------------------------
    copies = -(-BOOK_COPIES // SHARDED_WORLD) * SHARDED_WORLD
    t0 = time.perf_counter()
    ranks = distributed.run_ranks(
        SHARDED_WORLD, _world3_rank, (SHARDED_SCEN, copies), timeout_s=600,
        threads=2)
    if [r["rank"] for r in ranks] != list(range(SHARDED_WORLD)) \
            or ranks[0].get("gates") != "green":
        raise AssertionError("world 3: a rank is missing or rank 0's gates "
                             "did not run")
    B = mb.n_trades
    n_local = -(-B // SHARDED_WORLD)
    if B % SHARDED_WORLD == 0:
        raise AssertionError("world 3: the book divides; no padding ran")
    for r in ranks:
        lo = r["rank"] * n_local
        if r["trades"]["multibook"] != [lo, min(lo + n_local, B)]:
            raise AssertionError(f"world 3 rank {r['rank']}: trades "
                                 f"{r['trades']['multibook']}")
    rec["world_3"] = dict(backend="gloo", world_size=SHARDED_WORLD,
                          device="cuda:0 (every rank)", scenarios=SHARDED_SCEN,
                          book_trades=copies * 20, padded_trades=(
                              n_local * SHARDED_WORLD - B),
                          wall_s=time.perf_counter() - t0, ranks=ranks)
    print(f"phase 7f-b (world {SHARDED_WORLD}, gloo, one card): every gate "
          f"green on rank 0, each rank's K1 once a call on its own trades; "
          f"{rec['world_3']['wall_s']:.1f} s; {SHARDED_NOTE}", flush=True)

    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 7f-a/b: {rec['phase_s']:.1f} s; card {card}", flush=True)
    return rec


def run_f32_ladders(device, mb, q0, lad_fn, f64_warm_ms, n_warm: int = 3):
    """Phase 7f-c: the f32 ladders (``make_per_trade_delta_fn(dtype=
    torch.float32)``, K1's f32 instantiation) cold + ``n_warm`` warm on
    flagship_v5, held to phase 7b's f64 ladders (``lad_fn``) at the JAX
    package's own tolerance. Returns (its record, the fn, its info with
    the launches)."""
    import torch

    from adrates_torch.parallel import make_per_trade_delta_fn
    t0 = time.perf_counter()
    lad32_fn = make_per_trade_delta_fn(mb, device, dtype=torch.float32)
    lad32, info32 = _drive(f"f32 ladders [{mb.n_trades} x "
                           f"{mb.basket.n_quotes}]",
                           lambda q, _: lad32_fn(q), q0, None, n_warm)
    if lad32.dtype != torch.float32:
        raise AssertionError(f"f32 ladders have dtype {lad32.dtype}")
    if info32["pvs_sweep"] != info32["calls"]:
        raise AssertionError(f"f32 ladders: K1 launched "
                             f"{info32['pvs_sweep']} times in "
                             f"{info32['calls']} calls")
    lad64 = lad_fn(q0)
    atol = 3e-6 * float(lad64.abs().max())
    excess = (lad32.double() - lad64).abs() / (atol + 1e-4 * lad64.abs())
    _check("f32 ladders vs phase 7b's f64 ladders: worst |f32 - f64| / "
           "(3e-6 max|f64| + 1e-4 |f64|)", float(excess.max()), 1.0)
    info32["warm_median_ms"] = statistics.median(info32["warm_ms"])
    info32["pvs_sweep_tm_f32"] = info32["pvs_sweep"]
    rec = dict(info32, f64_warm_ms=f64_warm_ms,
               max_rel_err=_max_rel(lad32.double(), lad64))
    del lad32, lad64, excess
    torch.cuda.empty_cache()
    print(f"phase 7f-c: {time.perf_counter() - t0:.1f} s; card "
          f"{_card_line()}", flush=True)
    return rec, lad32_fn, info32


def compare_book_kernel(fn, rates, book, shocks, info) -> dict:
    """Phase 8's K1 record at the single-curve book's shape (phase 7e's
    fn, inputs and launch counts): K1 against its twin, timed beside it
    and one cuSPARSE SpMM of the trade x row CSR, with its bound."""
    import torch

    from adrates_torch.ops import kernels
    vT, bt = fn.value_table(rates, book, shocks)
    tab = bt.sweep
    M, S = vT.shape
    B, nnz = tab.n_trades, int(tab.slot_w.numel())
    ref = kernels.pvs_sweep_plain(vT, tab)
    err = float((kernels.pvs_sweep(vT, tab) - ref).abs().max())
    _check("single_curve_book K1 pvs_sweep vs plain (abs / max|ref|)",
           err / float(ref.abs().max()), 1e-12)
    with warnings.catch_warnings():          # CSR support is "beta"
        warnings.simplefilter("ignore", UserWarning)
        csr = torch.sparse_csr_tensor(tab.tptr.long(), tab.slot_col(),
                                      tab.slot_w, size=(B, M))
    vTc = vT.contiguous()
    _check("single_curve_book K1 cuSPARSE SpMM vs plain (abs / max|ref|)",
           float((torch.sparse.mm(csr, vTc).T - ref).abs().max()
                 / ref.abs().max()), 1e-12)
    tm = _timings(lambda: kernels.pvs_sweep(vT, tab),
                  lambda: kernels.pvs_sweep_plain(vT, tab),
                  lambda: torch.sparse.mm(csr, vTc))
    nbytes = 4 * (B + 1) + 12 * nnz + 8 * M * S + 8 * S * B
    bound, by = _bound(nbytes, 2.0 * nnz * S, FP64_FLOPS)
    print(f"single_curve_book K1 pvs_sweep vT [M, S]={[M, S]} B={B}, {nnz} "
          f"slots: {_fmt_tm(tm)}; bound {bound * 1e3:.1f} us ({by}, "
          f"{nbytes / 1e6:.1f} MB)", flush=True)
    return dict(name="pvs_sweep", path="single_curve_book", route="cuda",
                source="adrates_torch/csrc/pvs_sweep.cu",
                replaces="adrates_tpu/parallel/book.py:223",
                max_abs_err=err, **tm,
                library="torch.sparse.mm (cuSPARSE SpMM) of the [B, M] "
                        "trade x row CSR by vT",
                bound_ms=bound, bound_by=by, **_shares(bound, tm),
                tables_build_ms=info["tables_ms"],
                reuse=nnz / max(int(tab.brow.numel()), 1))


# Peak rates of one H100 SXM at its 700 W limit (NVIDIA's data sheet):
# HBM3 bytes/s, f64 FMA on the CUDA cores and on the tensor cores, f32 on
# the CUDA cores.
HBM_BPS = 3.35e12
FP64_FLOPS = 34e12
FP64_TC_FLOPS = 67e12
FP32_FLOPS = 67e12


def _bound(nbytes: float, flops: float, peak_flops: float):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    flops over the peak rate."""
    t_b, t_f = nbytes / HBM_BPS * 1e3, flops / peak_flops * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def _ladder_record(fn, q0, path) -> dict:
    """Phase 8's K1 record at the ladders' shape (a ladder fn of phase 7b
    or 7f-c: Jv [n_grid + T, N] and the tables in the ladder's dtype):
    the trade-major kernel as the path calls it, against its twin
    (1e-12 x max|ref| in f64; 1e-5 in f32, both summing in f32 in
    another order), timed beside the twin and one cuSPARSE SpMM of the
    same dtype (which writes [B, N] too), with its bound; the whole
    contraction as the path runs it (``fn.contract``: K1 and the clamp
    rows); and whether it equals the scenario-major kernel's sums
    transposed, bit for bit."""
    import torch

    from adrates_torch.ops import kernels
    dfs, Jt, Jv = fn.prep(q0)
    tab = fn.sweep
    M, S = Jv.shape
    B, nnz = tab.n_trades, int(tab.slot_w.numel())
    f32 = Jv.dtype == torch.float32
    if tab.slot_w.dtype != Jv.dtype:
        raise AssertionError(f"{path}: K1 inputs are {Jv.dtype}, "
                             f"{tab.slot_w.dtype}")
    name = "pvs_sweep_tm_f32" if f32 else "pvs_sweep_tm_f64"
    tol = 1e-5 if f32 else 1e-12
    ref = kernels.pvs_sweep_plain(Jv, tab, trade_major=True)
    got = kernels.pvs_sweep(Jv, tab, trade_major=True)
    err = float((got - ref).abs().max())
    _check(f"{path} K1 {name} vs plain (abs / max|ref|)",
           err / float(ref.abs().max()), tol)
    same = bool(torch.equal(got, kernels.pvs_sweep(Jv, tab).T))
    print(f"{path} K1 trade-major == scenario-major transposed, bit for "
          f"bit: {same}", flush=True)
    with warnings.catch_warnings():          # CSR support is "beta"
        warnings.simplefilter("ignore", UserWarning)
        csr = torch.sparse_csr_tensor(tab.tptr.long(), tab.slot_col(),
                                      tab.slot_w, size=(B, M))
    Jc = Jv.contiguous()
    _check(f"{path} cuSPARSE SpMM vs plain (abs / max|ref|)",
           float((torch.sparse.mm(csr, Jc) - ref).abs().max()
                 / ref.abs().max()), tol)
    tm = _timings(lambda: kernels.pvs_sweep(Jv, tab, trade_major=True),
                  lambda: kernels.pvs_sweep_plain(Jv, tab, trade_major=True),
                  lambda: torch.sparse.mm(csr, Jc))
    con = _device_stats(lambda: fn.contract(dfs, Jt, Jv))
    extra = dict(
        contraction_ms=_cuda_ms(lambda: fn.contract(dfs, Jt, Jv)),
        contraction_device_ms=con and con["median"],
        trade_major_equals_scenario_major=same)
    size = Jv.element_size()
    nbytes = 4 * (B + 1) + (4 + size) * nnz + size * (M * S + S * B)
    bound, by = _bound(nbytes, 2.0 * nnz * S,
                       FP32_FLOPS if f32 else FP64_FLOPS)
    plan = kernels.sweep_plan(S, Jv.dtype)
    print(f"{path} K1 {name} Jv [M, N]={[M, S]} B={B} ({plan.passes} "
          f"pass(es) of {plan.width} columns, {plan.smem_bytes} B of "
          f"shared memory): {_fmt_tm(tm)}; the contraction "
          f"{extra['contraction_ms']:.4f} ms (device "
          f"{_fmt_ms(extra['contraction_device_ms'])}); bound "
          f"{bound * 1e3:.1f} us ({by}, {nbytes / 1e6:.1f} MB)", flush=True)
    return dict(
        name=name, path=path, route="cuda",
        source="adrates_torch/csrc/pvs_sweep.cu",
        replaces="adrates_tpu/parallel/multibook.py:2842",
        max_abs_err=err, **tm,
        library=f"torch.sparse.mm (cuSPARSE SpMM{', f32' if f32 else ''}) "
                f"of the [B, M] trade x column CSR by Jv",
        bound_ms=bound, bound_by=by, **_shares(bound, tm), **extra)


def _dense_chain(denom, tab):
    """[R, P, P] dense unit lower (I - A) of every row of a K4 / K5 call
    (row r on plan row r mod G)."""
    import torch
    R, P = denom.shape
    G = tab.prev.shape[0]
    prev = tab.prev.long()[torch.arange(R, device=denom.device) % G]
    M = torch.eye(P, dtype=denom.dtype, device=denom.device).repeat(R, 1, 1)
    r, i = torch.nonzero(prev >= 0, as_tuple=True)
    M[r, i, prev[r, i]] = -1.0 / denom[r, i]
    return M


def compare_solve_kernels(path, inputs, label=None) -> list:
    """Phase 8's K4 and K5 records at one path's largest solve
    (``inputs`` from ``_capture_solves``): K4 against its plain K-sweep
    bit for bit, K5 against its child-table sweep at 1e-14 x max|ref|;
    each timed beside its plain version and one batched
    ``torch.linalg.solve_triangular`` on the dense unit triangular (I - A)
    of every row (built outside the timed window; the port never calls
    it), and on one row of each plan (its chain of P dependent steps,
    which no number of rows shortens); its bound is bytes (each input
    read once, the output written once) over the HBM rate against the
    2 R P divisions and additions over the f64 rate. ``label`` says what
    the captured call is, on the records."""
    import torch

    from adrates_torch.ops import kernels
    recs = []
    for name, line in (("pv01_solve", 332), ("pv01_solve_t", 338)):
        rhs, denom, tab = inputs[name]
        kern, plain = getattr(kernels, name), getattr(kernels, name + "_plain")
        R, P = rhs.shape
        G = tab.prev.shape[0]
        ref = plain(rhs, denom, tab)
        got = kern(rhs, denom, tab)
        err = float((got - ref).abs().max())
        exact = bool(torch.equal(got, ref))
        if name == "pv01_solve":
            _check(f"{path} K4 pv01_solve vs plain, bit for bit (abs)",
                   err, 0.0)
            if not exact:
                raise AssertionError(f"{path} K4 differs from its plain "
                                     f"version")
        else:
            _check(f"{path} K5 pv01_solve_t vs plain (abs / max|ref|)",
                   err / float(ref.abs().max()), 1e-14)
        M = _dense_chain(denom, tab)
        if name == "pv01_solve_t":
            M = M.mT.contiguous()
        b3 = rhs.unsqueeze(-1)
        upper = name == "pv01_solve_t"

        def library():
            return torch.linalg.solve_triangular(M, b3, upper=upper,
                                                 unitriangular=True)

        _check(f"{path} {name} yardstick solve_triangular vs plain (abs / "
               f"max|ref|)", float((library()[..., 0] - ref).abs().max()
                                   / ref.abs().max()), 1e-12)
        tm = _timings(lambda: kern(rhs, denom, tab),
                      lambda: plain(rhs, denom, tab), library)
        r1, d1 = rhs[:G].contiguous(), denom[:G].contiguous()
        chain = _device_stats(lambda: kern(r1, d1, tab))
        chain_ms = chain and chain["median"]
        nbytes = 24 * R * P + 4 * G * P
        bound, by = _bound(nbytes, 2.0 * R * P, FP64_FLOPS)
        print(f"{path} {name} [R, P]={[R, P]} on {G} plan(s): "
              f"{_fmt_tm(tm)}; one row a plan {_fmt_ms(chain_ms)} (the "
              f"chain); bound {bound * 1e3:.2f} us ({by}, "
              f"{nbytes / 1e6:.2f} MB); bit for bit {exact}", flush=True)
        recs.append(dict(
            name=name, path=path, route="cuda",
            source="adrates_torch/csrc/pv01_solve.cu",
            replaces=f"adrates_tpu/ops/bootstrap.py:{line}",
            max_abs_err=err, **tm,
            library="torch.linalg.solve_triangular (unitriangular) on the "
                    "dense [R, P, P] (I - A)" + ("^T" if upper else ""),
            bound_ms=bound, bound_by=by, **_shares(bound, tm),
            label=label, rows=R, points=P, plans=G, bit_for_bit=exact,
            chain_ms=chain_ms,
            chain_step_ns=chain_ms and chain_ms * 1e6 / P,
            chain_share=chain_ms and tm["device_ms"]
            and chain_ms / tm["device_ms"]))
        del M
    return recs


# K13 / K14's: the OIS stage's passes of the structured split
_OIS_SRC = dict(
    ois_stage_jvp=("adrates_tpu/parallel/structured_risk.py:296",
                   ["adrates_tpu/ops/bootstrap.py:213",
                    "adrates_tpu/ops/interpolation.py:325"]),
    ois_stage_hess=("adrates_tpu/parallel/structured_risk.py:604",
                    ["adrates_tpu/ops/bootstrap.py:213",
                     "adrates_tpu/ops/interpolation.py:325"]))


def compare_ois_kernels(path, inputs) -> list:
    """Phase 8's K13 and K14 records at one path's captured OIS stage
    calls (``inputs`` from ``_capture_xccy(..., names=OIS)``: the first
    chunk's arguments): each against its plain version (torch.func over
    ois_native_ds and stage_rows on the same tables, on the card) at
    1e-12 x max|ref| of every output, launched twice on its inputs (equal
    bit for bit, a gate) with no local memory (a gate), timed (30 calls by
    events and by profiler device time; the plain version over 5 calls)
    with no library call (no single PyTorch call computes a bootstrap's
    jacobian or Hessian); the bound is bytes (``ois_stage.needed_bytes``:
    the tables each kernel reads, the quotes and cotangents read once, the
    outputs written once) over the HBM rate against the f64 operations
    the function needs over the f64 rate (``ois_stage.needed_flops``: the
    chain's primal once a (scenario, member), each direction's tangents
    once, counted on the kernels' lanes emulated in Python)."""
    import torch

    from adrates_torch.ops import kernels
    from adrates_torch.ops import ois_stage as os_
    recs = []
    for name in OIS:
        args = list(inputs[name])
        tab, Sc = args[0], args[1].shape[0]
        kern, plain = getattr(kernels, name), getattr(os_, name + "_plain")

        def outs(f):
            r = f(*args)
            return list(r) if isinstance(r, tuple) else [r]
        ref, got = outs(plain), outs(kern)
        rels = [float((a - b).abs().max() / b.abs().max())
                for a, b in zip(got, ref)]
        err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
        _check(f"{path} {name} vs plain (abs / max|ref|, worst output)",
               max(rels), 1e-12)
        repeat = all(torch.equal(a, b) for a, b in zip(got, outs(kern)))
        info = kernels.ois_kernel_info(tab, name)
        print(f"{path} {name}: two launches on one input equal bit for "
              f"bit: {repeat}; {info}", flush=True)
        if not repeat or info["local_bytes"]:
            raise AssertionError(f"{path} {name}: two launches differ or "
                                 f"local memory: {info}")
        tm = dict(ms=_cuda_ms(lambda: kern(*args)))
        dv = _device_stats(lambda: kern(*args))
        tm.update(device_ms=dv and dv["median"],
                  device_ms_min=dv and dv["min"],
                  device_ms_max=dv and dv["max"],
                  device_by_launch=dv and dv["by_launch"],
                  plain_ms=_cuda_ms(lambda: plain(*args), reps=5),
                  library_ms=None, library_device_ms=None)
        flops = os_.needed_flops(name, *args)
        nbytes = os_.needed_bytes(name, *args)
        bound, by = _bound(nbytes, flops, FP64_FLOPS)
        print(f"{path} {name} [Sc, G, P, Qp, W]="
              f"{[Sc, tab.G, tab.P, tab.Qp, tab.W]}: {_fmt_tm(tm)}; bound "
              f"{bound * 1e3:.2f} us ({by}, {nbytes / 1e6:.2f} MB, "
              f"{flops / 1e9:.5f} GFLOP); worst rel err {max(rels):.2e}",
              flush=True)
        replaces, also = _OIS_SRC[name]
        recs.append(dict(
            name=name, path=path, route="cuda",
            source="adrates_torch/csrc/ois_stage.cu",
            replaces=replaces, replaces_also=also, max_abs_err=err,
            max_rel_err=max(rels), **tm,
            library="none: no single PyTorch call computes a bootstrap's "
                    "jacobian or Hessian",
            bound_ms=bound, bound_by=by, **_shares(bound, tm),
            scenarios=Sc, members=tab.G, points=tab.P, quotes=tab.Qp,
            rows=tab.W, flops=flops, bytes=nbytes, bit_for_bit_repeat=repeat,
            registers=info["registers"], local_bytes=info["local_bytes"],
            smem_bytes=info["smem_bytes"],
            blocks_per_sm=info["blocks_per_sm"], blocks=Sc * tab.G,
            on_path=True, inputs="captured"))
        del got, ref
    return recs


# K8-K11's sources and the JAX package's functions they replace (no
# Pallas kernel: plain jnp, which XLA lowers)
_XCCY_SRC = dict(
    xccy_stage_jvp=("adrates_tpu/parallel/structured_risk.py:321",
                    ["adrates_tpu/ops/xccy_bootstrap.py:78",
                     "adrates_tpu/parallel/curve_batching.py:265"]),
    xccy_legs_jvp=("adrates_tpu/parallel/structured_risk.py:367",
                   ["adrates_tpu/ops/pricers.py:102"]),
    xccy_stage_hess=("adrates_tpu/parallel/structured_risk.py:529",
                     ["adrates_tpu/ops/xccy_bootstrap.py:78"]),
    xccy_legs_hess=("adrates_tpu/parallel/structured_risk.py:552",
                    ["adrates_tpu/ops/pricers.py:102"]),
    xccy_stage_node_hess=("adrates_tpu/parallel/structured_risk.py:949",
                          ["adrates_tpu/parallel/structured_risk.py:886",
                           "adrates_tpu/parallel/structured_risk.py:688"]))


def compare_xccy_kernels(path, inputs, stage=None, names=XCCY) -> list:
    """Phase 8's records of the kernels ``names`` (K8-K11, or the
    per-trade call's K12, K9 and K11) at one path's captured XCCY calls
    (``inputs`` from ``_capture_xccy``: the first chunk's arguments): K8,
    K10 and K12 on the captured inputs; K9 and K11 on the captured grids and
    cotangents through ``xccy_stage.probe_tables`` with seeded domestic
    tangents, since a book's calibration legs price to 0 on any curve (so
    their PVs and derivatives are rounding alone); each against its plain
    version (torch.func on the same tables) at 1e-12 x max|ref| of every
    output, the Hessians' mirror entries bit for bit, timed (30 calls by
    events and by profiler device time; the plain version over 5 calls)
    with no library call (no single PyTorch call computes a stage's
    jacobian or Hessian); the bound is bytes (``xccy_stage.needed_bytes``:
    the tables the kernel reads, the scenario inputs and each grid only
    at the entries its plan reads, read once, the outputs written once)
    over the HBM rate against the f64 operations the function needs
    over the f64 rate (``xccy_stage.needed_flops``: the primal once a
    (scenario, member), each first tangent once, each pair's e1 e2 part
    once; exp and log one each), the kernel's own count beside it
    (``thread_flops``: K8 / K10 split at the node DFs, their blocks' dual
    chains, rows and pairs' hyper-dual chains; K9 / K11 split at the legs'
    flows, the flows and the collapse onto the domestic grid once a
    (scenario, member), then a dot a direction or pair;
    ``simple_thread_flops``, a thread the whole stage, the first design
    of K8-K11); where the kernel's own count falls below the need (the
    collapse's dots over the grid's rows cost less than a dual number's
    tangent through every operation), the bound takes the smaller count
    (``bound_flops``); each kernel launched twice on its inputs (equal
    bit for bit, a gate), and its registers, local bytes a thread, shared
    memory a block and blocks an SM from the card's compiler
    (``kernels.xccy_kernel_info``). ``stage`` labels the stage of a path
    with several XCCY stages (the records carry it; a stage over fitted
    parents holds its query grids, ``Lf`` / ``Ld`` their lengths).
    """
    import numpy as np
    import torch

    from adrates_torch.ops import kernels
    from adrates_torch.ops import xccy_stage as xs
    recs = []
    label = path if stage is None else f"{path} stage {stage}"
    for name in names:
        k = (XCCY + NODE).index(name)
        args = list(inputs[name])
        tab = args[0]
        Sc = args[1].shape[0]
        if name in ("xccy_legs_jvp", "xccy_legs_hess"):
            tab = xs.probe_tables(tab, 31 + k)
            args[0] = tab
            args[2] = torch.as_tensor(1e-3 * np.random.default_rng(
                41 + k).standard_normal(tuple(args[2].shape)),
                device=args[1].device)
        G = tab.G
        kern, plain = getattr(kernels, name), getattr(xs, name + "_plain")
        ref = [r for r in plain(*args) if r is not None]
        got = [r for r in kern(*args) if r is not None]
        rels = [float((a - b).abs().max() / b.abs().max())
                for a, b in zip(got, ref)]
        err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
        _check(f"{label} {name} vs plain (abs / max|ref|, worst output)",
               max(rels), 1e-12)
        if name.endswith("hess"):
            H = got[-1]
            mirror = H.transpose(1, 2) if name == "xccy_stage_node_hess" \
                else H.permute(0, 3, 2, 1)
            if not torch.equal(H, mirror):
                raise AssertionError(f"{label} {name}: H not symmetric bit "
                                     f"for bit")
        again = [r for r in kern(*args) if r is not None]
        repeat = all(torch.equal(a, b) for a, b in zip(got, again))
        info = kernels.xccy_kernel_info(tab, name)
        print(f"{label} {name}: two launches on one input equal bit for "
              f"bit: {repeat}; {info}", flush=True)
        if not repeat:
            raise AssertionError(f"{label} {name}: two launches on one "
                                 f"input differ")
        if name == "xccy_stage_node_hess":
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            if info["local_bytes"] or info["blocks"] * Sc < sms:
                raise AssertionError(f"{label} {name}: local memory or "
                                     f"fewer blocks than SMs ({sms}): "
                                     f"{info}")
        del again
        ms = _cuda_ms(lambda: kern(*args))
        dv = _device_stats(lambda: kern(*args))
        tm = dict(ms=ms, device_ms=dv and dv["median"],
                  device_ms_min=dv and dv["min"],
                  device_ms_max=dv and dv["max"],
                  device_by_launch=dv and dv["by_launch"],
                  plain_ms=_cuda_ms(lambda: plain(*args), reps=5),
                  library_ms=None, library_device_ms=None)
        if name == "xccy_stage_node_hess":
            # its two launches: each one's device ms, blocks and warps
            tm.update(launch_device_ms=dv and dv["by_name"],
                      blocks=info["blocks"], warps=info["warps"],
                      prologue=info["prologue"], pairs=info["pairs"],
                      prologue_blocks=info["blocks_per_member"] * G * Sc)
            print(f"{label} {name}: device ms a launch "
                  f"{tm['launch_device_ms']}; prologue "
                  f"{tm['prologue_blocks']} blocks {info['prologue']}, "
                  f"pairs {info['blocks']} blocks of {info['warps']} "
                  f"warps {info['pairs']}", flush=True)
        ops = xs.needed_flops(name, *args)
        flops = ops["needed"]
        nbytes = xs.needed_bytes(name, *args)
        bound_flops = min(flops, ops["kernel"])
        bound, by = _bound(nbytes, float(bound_flops), FP64_FLOPS)
        print(f"{label} {name} "
              f"[Sc, G, S, D, Qd, W, Lf, Ld]="
              f"{[Sc, G, tab.S, tab.D, tab.Qd, tab.W, tab.Lf, tab.Ld]}: "
              f"{_fmt_tm(tm)}; "
              f"bound {bound * 1e3:.2f} us ({by}, {nbytes / 1e6:.2f} MB, "
              f"{flops / 1e9:.4f} GFLOP needed, the kernel's own "
              f"{ops['kernel'] / 1e9:.4f}, the bound's "
              f"{bound_flops / 1e9:.4f}, a thread the whole stage "
              f"{ops['threads'] / 1e9:.4f}); worst rel err "
              f"{max(rels):.2e}", flush=True)
        replaces, also = _XCCY_SRC[name]
        recs.append(dict(
            name=name, path=path, route="cuda",
            source="adrates_torch/csrc/xccy_stage.cu",
            replaces=replaces, replaces_also=also,
            max_abs_err=err, max_rel_err=max(rels), **tm,
            library="none: no single PyTorch call computes a stage's "
                    "jacobian or Hessian",
            bound_ms=bound, bound_by=by, **_shares(bound, tm),
            scenarios=Sc, members=G, spreads=tab.S, directions=tab.D,
            dom_directions=tab.Qd, rows=tab.W, foreign_grid=tab.Lf,
            dom_grid=tab.Ld, query_grids=[k for k, f in (
                ("foreign", tab.ffit), ("domestic", tab.dfit))
                if f is not None], stage=stage, on_path=True, flops=flops,
            thread_flops=ops["kernel"], bound_flops=bound_flops,
            simple_thread_flops=ops["threads"],
            bit_for_bit_repeat=repeat, registers=info["registers"],
            local_bytes=info["local_bytes"], smem_bytes=info["smem_bytes"],
            blocks_per_sm=info["blocks_per_sm"], tile=info["tile"],
            held_in_smem=info["held"],
            inputs="captured" if name in ("xccy_stage_jvp",
                                          "xccy_stage_hess",
                                          "xccy_stage_node_hess")
            else "captured grids and cotangents, probe legs, seeded "
                 "tangents"))
    return recs


def _fit_operators(tab):
    """[G, W_max, K n_max]: each member's dense operator from (its knot
    values | its slopes) to its queries, built once by K6 on the unit
    basis (outside any timed window; the port never calls it)."""
    import torch

    from adrates_torch.ops import kernels
    kn = tab.K * tab.n_max
    eye = torch.eye(kn, dtype=torch.float64, device=tab.qw.device)
    X = eye.reshape(kn, 1, tab.K, tab.n_max).expand(
        kn, tab.G, tab.K, tab.n_max).contiguous()
    return kernels.fitted_rows(X, tab).permute(1, 2, 0).contiguous()


# flops counted for one log or exp in K6's bound (a polynomial of about
# ten FMAs and the scaling around it)
FIT_TRANSCENDENTAL_FLOPS = 20


def _eval_fit_bound(name, R, D, tab, plan):
    """K6 ``fitted_eval`` / ``fitted_eval_jvp``'s bound at R primal rows
    (D directions): bytes (each real knot's DF read once, and its tangents;
    the values written once, and in tangent mode read once and their
    tangents written once; the tables once: brackets, weights, fac, the
    factors and fx) over the HBM rate against the operations (a log and a
    division a knot, a direction's division or two; PCHIP's slope or the
    spline's sweeps, 10 a knot; the Hermite row 8, exp and fac) over the
    f64 rate. Returns (bound ms, bound_by, bytes, flops)."""
    G, W, n = tab.G, tab.W_max, tab.n_max
    kn = int(tab.nk.sum())
    tables = 16 * G + 44 * G * W + 88 * G * n
    tr = FIT_TRANSCENDENTAL_FLOPS
    if name == "fitted_eval":
        nbytes = 8 * R * kn + 8 * R * G * W + tables
        flops = R * kn * (tr + 11) + R * G * W * (9 + tr)
    else:
        nbytes = 8 * R * kn * (1 + D) + 8 * R * G * W * (1 + D) + tables
        flops = R * kn * (tr + 1) + R * D * kn * 12 + R * D * G * W * 10
    bound, by = _bound(nbytes, flops, FP64_FLOPS)
    return bound, by, nbytes, flops


def _eval_fit_record(region, name, shape, args) -> dict:
    """Phase 8's record of K6 ``fitted_eval`` or its tangent mode at one
    captured call (``args``: its inputs as the path gave them): against
    its plain version at 1e-12 x max|ref| and its own second launch bit
    for bit, timed beside the plain version; no PyTorch call computes the
    whole function (the linear core's torch.bmm stands on the
    ``fitted_rows`` records); the kernel's registers, local bytes and
    tiles."""
    import torch

    from adrates_torch.ops import fitted_rows as tfr
    from adrates_torch.ops import kernels
    plan = args[-1]
    tab = plan.tables
    path = f"flagship_v5_splines_{region}"
    if name == "fitted_eval":
        dfs, = args[:-1]
        R, D = dfs.shape[0], 0

        def kern():
            return kernels.fitted_eval(dfs, plan)

        def plain():
            return tfr.fitted_eval_plain(plan, dfs)
    else:
        dfs, ddfs, out = args[:-1]
        R, D = ddfs.shape[:2]

        def kern():
            return kernels.fitted_eval_jvp(dfs, ddfs, out, plan)

        def plain():
            return tfr.fitted_eval_jvp_plain(plan, dfs, ddfs, out)
    ref = plain()
    got = kern()
    err = float((got - ref).abs().max())
    _check(f"{path} {name} vs plain (abs / max|ref|)",
           err / float(ref.abs().max()), 1e-12)
    repeat = bool(torch.equal(got, kern()))
    print(f"{path} {name}: two launches on one input equal bit for bit: "
          f"{repeat}", flush=True)
    if not repeat:
        raise AssertionError(f"{path} {name}: two launches on one input "
                             f"differ")
    del got, ref
    info = kernels.fitted_kernel_info(
        "eval" if name == "fitted_eval" else "tangent", R, tab.G, tab.n_max,
        tab.W_max, D=D)
    tm = _timings(kern, plain)
    bound, by, nbytes, flops = _eval_fit_bound(name, R, D, tab, plan)
    print(f"{path} {name} [R, D, G, n_max, W_max]="
          f"{[R, D, tab.G, tab.n_max, tab.W_max]} (kinds "
          f"{tab.kind.tolist()}, knots {tab.nk.tolist()}; tiles {info}): "
          f"{_fmt_tm(tm)}; bound {bound * 1e3:.2f} us ({by}, "
          f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.4f} GFLOP)", flush=True)
    return dict(
        name=name, path=path, route="cuda",
        source="adrates_torch/csrc/fitted_rows.cu",
        replaces="adrates_tpu/ops/interpolation.py:350",
        replaces_also=["adrates_tpu/ops/interpolation.py:375",
                       "adrates_tpu/parallel/curve_batching.py:320"],
        max_abs_err=err, **tm,
        library="none: no PyTorch call computes the fitted schemes' "
                "evaluation (the linear core's torch.bmm is on the "
                "fitted_rows records)",
        bound_ms=bound, bound_by=by, bound_bytes=nbytes, bound_flops=flops,
        **_shares(bound, tm), rows=R, directions=D, members=tab.G,
        knots=tab.n_max, queries=tab.W_max, bit_for_bit_repeat=repeat,
        **info)


def _linear_fit_records(inputs) -> list:
    """Phase 8's records of K6's linear map and K7 at the spline book's
    captured shapes (``inputs``: each call's shape and tables; K6's
    largest call in the 256 dense gammas, the one path that launches it,
    and, off the path (``on_path`` false), at regions A's and C1's tangent
    calls; K7's largest calls in regions C1 and C2 and the 256 dense
    gammas),
    on standard normal inputs drawn from a seed (the kernels' work does
    not depend on the values; a captured cotangent can be one whose exact
    image is 0, as the calibration legs' are, their floating coupons and
    principal telescoping, and then both results are rounding alone):
    each against its twin at 1e-12 x max|ref| (the kernels solve a
    spline's slopes by Thomas sweeps, the twins by PCR, and sum in
    another order) and against its own second launch bit for bit, timed
    beside the twin and one batched ``torch.bmm`` of the inputs by the
    members' dense operators (checked against the twin too); the bound
    is bytes (the input read once, the output written once, the tables
    once) over the HBM rate against the FMAs over the f64 rate."""
    import numpy as np
    import torch

    from adrates_torch.ops import kernels
    recs = []
    for k, ((region, name), (shape, tab)) in enumerate(inputs.items()):
        t = torch.as_tensor(np.random.default_rng(15 + k).standard_normal(
            shape), device=tab.qw.device)
        kern, plain = getattr(kernels, name), getattr(kernels,
                                                      name + "_plain")
        R, G, W, n, K = t.shape[0], tab.G, tab.W_max, tab.n_max, tab.K
        path = f"flagship_v5_splines_{region}"
        ref = plain(t, tab)
        got = kern(t, tab)
        err = float((got - ref).abs().max())
        _check(f"{path} {name} vs plain (abs / max|ref|)",
               err / float(ref.abs().max()), 1e-12)
        repeat = bool(torch.equal(got, kern(t, tab)))
        print(f"{path} {name}: two launches on one input equal bit for "
              f"bit: {repeat}", flush=True)
        if not repeat:
            raise AssertionError(f"{path} {name}: two launches on one "
                                 f"input differ")
        M = _fit_operators(tab)                       # [G, W, K n]
        if name == "fitted_rows":
            a = t.reshape(R, G, K * n).permute(1, 0, 2).contiguous()
            b = M.transpose(1, 2).contiguous()
            lib_ref = ref.permute(1, 0, 2)
        else:
            a = t.permute(1, 0, 2).contiguous()
            b = M
            lib_ref = ref.reshape(R, G, K * n).permute(1, 0, 2)

        def library(a=a, b=b):
            return torch.bmm(a, b)

        _check(f"{path} {name} yardstick torch.bmm vs plain (abs / "
               f"max|ref|)", float((library() - lib_ref).abs().max()
                                   / lib_ref.abs().max()), 1e-12)
        tm = _timings(lambda: kern(t, tab), lambda: plain(t, tab), library)
        n_spl = int(tab.nk[tab.kind != kernels.FIT_HERMITE].sum())
        tables = 12 * G + 36 * G * W + 48 * G * n \
            + (4 * G * n + 4 * G * W if name == "fitted_rows_t" else 0)
        nbytes = 8 * R * G * (K * n + W) + tables
        bound, by = _bound(nbytes, 8.0 * R * G * W + 10.0 * R * n_spl,
                           FP64_FLOPS)
        on_path = not (name == "fitted_rows" and region in ("A", "C1"))
        tiles = (kernels.fitted_kernel_info("linear", R, G, n, W)
                 if name == "fitted_rows" else {})
        print(f"{path} {name} [R, G, K, n_max, W_max]={[R, G, K, n, W]} "
              f"(kinds {tab.kind.tolist()}, knots "
              f"{tab.nk.tolist()}"
              + (f"; tiles {tiles}" if tiles else "")
              + ("" if on_path else "; off the main path: no path launches "
                 "it at this shape") + f"): {_fmt_tm(tm)}; bound "
              f"{bound * 1e3:.2f} us ({by}, {nbytes / 1e6:.2f} MB)",
              flush=True)
        recs.append(dict(
            name=name, path=path, route="cuda",
            source="adrates_torch/csrc/fitted_rows.cu",
            replaces="adrates_tpu/ops/interpolation.py:350",
            replaces_also=["adrates_tpu/ops/interpolation.py:375",
                           "adrates_tpu/parallel/curve_batching.py:320"],
            max_abs_err=err, **tm,
            library="torch.bmm of the inputs by the members' dense "
                    + ("operators [G, K n_max, W_max]" if name == "fitted_rows"
                       else "operators [G, W_max, K n_max] (the transpose)"),
            bound_ms=bound, bound_by=by, **_shares(bound, tm),
            rows=R, members=G, knots=n, queries=W, slots=K,
            bit_for_bit_repeat=repeat, on_path=on_path, **tiles))
        del M, a, b
    return recs


def compare_fitted_kernels(inputs) -> list:
    """Phase 8's K6 and K7 records at the spline book's captured calls
    (``inputs`` from ``_capture_fitted`` and ``_watch_fitted``): K6's
    evaluation and its tangent mode on the captured inputs
    (``_eval_fit_record``), then K6's linear map and K7 on seeded inputs
    at their captured shapes (``_linear_fit_records``)."""
    new = {k: v for k, v in inputs.items()
           if k[1] in ("fitted_eval", "fitted_eval_jvp")}
    recs = [_eval_fit_record(region, name, *v)
            for (region, name), v in new.items()]
    return recs + _linear_fit_records(
        {k: v for k, v in inputs.items() if k not in new})


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
    # yardstick: one cuSPARSE SpMM of the trade x column CSR by vT
    with warnings.catch_warnings():          # CSR support is "beta"
        warnings.simplefilter("ignore", UserWarning)
        csr = torch.sparse_csr_tensor(tab.tptr.long(), tab.slot_col(),
                                      tab.slot_w, size=(B, M))
    vTc = vT.contiguous()
    lib = torch.sparse.mm(csr, vTc)
    _check(f"{path} K1 cuSPARSE SpMM vs plain (abs / max|ref|)",
           float((lib.T - ref).abs().max() / ref.abs().max()), 1e-12)
    tm1 = _timings(lambda: kernels.pvs_sweep(vT, tab),
                   lambda: kernels.pvs_sweep_plain(vT, tab),
                   lambda: torch.sparse.mm(csr, vTc))
    del lib, csr, vTc
    # the function's bytes: a plain trade x column CSR (trade pointer,
    # 4-byte column and 8-byte weight per slot), vT and out; the
    # kernel's own block row lists (bptr, brow) are not counted
    bytes1 = 4 * (B + 1) + 12 * nnz + 8 * M * S + 8 * S * B
    bound1, by1 = _bound(bytes1, 2.0 * nnz * S, FP64_FLOPS)
    print(f"{path} K1 pvs_sweep vT [M, S]={[M, S]} B={B}: {_fmt_tm(tm1)}; "
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
    # yardstick: one torch.bmm over (scenario, group) of the padded
    # [w X; Y] and [Y; w X] (gathered, and scattered into G, untimed)
    L, R = _k2_operands(J, dfs_c, qt)
    Lt = L.transpose(1, 2)
    lib = _k2_scatter(torch.bmm(Lt, R), qt, J.shape)
    _check(f"{path} K2 yardstick bmm vs plain (abs / max|ref|)",
           float((lib - ref).abs().max() / ref.abs().max()), 1e-12)
    tm2 = _timings(lambda: kernels.gamma_quad_form_grouped(J, dfs_c, qt),
                   lambda: kernels.gamma_quad_form_grouped_plain(
                       J, dfs_c, qt),
                   lambda: torch.bmm(Lt, R))
    del lib
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
    print(f"{path} K2 gamma_quad_form_grouped J={list(J.shape)}: "
          f"{_fmt_tm(tm2)}, bmm operands {list(L.shape)}; J values needed "
          f"{need_j} per scenario ({8 * Sc * need_j / 1e6:.1f} MB per call), "
          f"gathered {gathered} ({8 * Sc * gathered / 1e6:.1f} MB); bound "
          f"{bound2 * 1e3:.1f} us ({by2}, {bytes2 / 1e6:.1f} MB)",
          flush=True)
    del J, ref, got, L, R, Lt
    torch.cuda.empty_cache()
    return [
        dict(name="pvs_sweep", path=path, route="cuda",
             source="adrates_torch/csrc/pvs_sweep.cu",
             replaces="adrates_tpu/parallel/multibook.py:1782",
             max_abs_err=err1, **tm1,
             library="torch.sparse.mm (cuSPARSE SpMM) of the [B, M] "
                     "trade x column CSR by vT",
             bound_ms=bound1, bound_by=by1, **_shares(bound1, tm1),
             tables_build_ms=build_ms, reuse=nnz / max(n_rows, 1)),
        dict(name="gamma_quad_form_grouped", path=path, route="cuda",
             source="adrates_torch/csrc/gamma_quad_form.cu",
             replaces="adrates_tpu/parallel/multibook.py:1660",
             max_abs_err=err2, **tm2,
             library="torch.bmm over (scenario, group) of the "
                     "pre-gathered, padded [S x groups, 2 T_max, k_max] "
                     "operands [w X; Y] and [Y; w X] (gather and scatter "
                     "into G not timed)",
             bound_ms=bound2, bound_by=by2, **_shares(bound2, tm2),
             j_needed_mb=8 * Sc * need_j / 1e6,
             j_gathered_mb=8 * Sc * gathered / 1e6),
    ]


def _k2_operands(J, dfs, qt):
    """K2's yardstick operands: per (scenario, group) the padded
    [2 T_max, k_max] stacks L = [w X; Y] and R = [Y; w X] of the group's
    trips (T_max the most trips of a group, k_max the widest; pad rows and
    columns zero), so that Lᵀ R is the group's block P = Z + Zᵀ;
    [S * n_groups, 2 T_max, k_max] each."""
    import torch
    S, N, n_grid = J.shape
    tptr, rptr = qt.tptr.tolist(), qt.rptr.tolist()
    G = qt.n_groups
    T = max(tptr[g + 1] - tptr[g] for g in range(G))
    K = max(rptr[g + 1] - rptr[g] for g in range(G))
    L = J.new_zeros((S, G, 2 * T, K))
    R = torch.zeros_like(L)
    Jf = J.reshape(S, -1)
    for g in range(G):
        ts = slice(tptr[g], tptr[g + 1])
        Tg = ts.stop - ts.start
        s_i, e_i, p_i = (x[ts].long() for x in (qt.s_idx, qt.e_idx,
                                                 qt.p_idx))
        rows = qt.rows[rptr[g]:rptr[g + 1]].long()
        k = rows.shape[0]
        a, b, c = dfs[:, s_i], dfs[:, e_i], dfs[:, p_i]        # [S, T_g]
        base = rows[None, :] * n_grid
        Ja, Jb, Jc = (Jf[:, x[:, None] + base] for x in (s_i, e_i, p_i))
        X = (Ja - (a / b)[..., None] * Jb) / b[..., None]       # [S, T_g, k]
        Y = Jc - (c / b)[..., None] * Jb
        wX = X * qt.w[ts][None, :, None]
        L[:, g, :Tg, :k] = wX
        L[:, g, T:T + Tg, :k] = Y
        R[:, g, :Tg, :k] = Y
        R[:, g, T:T + Tg, :k] = wX
    return L.reshape(S * G, 2 * T, K), R.reshape(S * G, 2 * T, K)


def _k2_scatter(P, qt, shape):
    """[S, N, N] G from the yardstick's [S * n_groups, k_max, k_max]
    blocks, summed into each group's rows in group order."""
    import torch
    S, N, _ = shape
    G = torch.zeros((S, N, N), dtype=P.dtype, device=P.device)
    P = P.reshape(S, qt.n_groups, P.shape[1], P.shape[2])
    rptr = qt.rptr.tolist()
    for g in range(qt.n_groups):
        rows = qt.rows[rptr[g]:rptr[g + 1]].long()
        k = rows.shape[0]
        G[:, rows[:, None], rows[None, :]] += P[:, g, :k, :k]
    return G


def _k3_operands(Jt, dfs, w, tab):
    """The yardstick's operands: per item the padded [2K, k_max] stacks
    L = [w X; Y] and R = [Y; w X] of its slots (K the most slots of an
    item, k_max the widest group; pad rows and columns zero), so that
    Lᵀ R is its block."""
    import torch
    n_grid, N = Jt.shape
    ws = w[tab.order]
    counts = (tab.iptr[1:] - tab.iptr[:-1]).long()
    K = max(int(counts.max()), 1)
    k_max = max(tab.ks)
    n_items = counts.shape[0]
    rows = torch.full((len(tab.ks), k_max), N, dtype=torch.int64,
                      device=Jt.device)
    qptr = tab.qptr.tolist()
    for g, k in enumerate(tab.ks):
        rows[g, :k] = tab.qrows[qptr[g]:qptr[g + 1]].long()
    Jp = torch.cat([Jt, Jt.new_zeros((n_grid, 1))], dim=1)
    it = tab.sitem
    sel = rows[tab.igrp.long()[it]]                       # [nnz, k_max]
    s, e, p = (x.long()[:, None] for x in (tab.s_idx, tab.e_idx,
                                           tab.p_idx))
    a, b, c = dfs[s], dfs[e], dfs[p]
    X = (Jp[s, sel] - (a / b) * Jp[e, sel]) / b
    Y = Jp[p, sel] - (c / b) * Jp[e, sel]
    pos = torch.arange(it.shape[0], device=Jt.device) - tab.iptr.long()[it]
    L = Jt.new_zeros((n_items, 2 * K, k_max))
    R = torch.zeros_like(L)
    L[it, pos] = ws[:, None] * X
    L[it, K + pos] = Y
    R[it, pos] = Y
    R[it, K + pos] = ws[:, None] * X
    return L, R


def _k3_bytes_flops(tab, n_grid: int, n_quotes: int):
    """The bytes K3's function must move and its flops (4 k^2 per slot),
    from the tables. Bytes: the slot table; the Jt values its items need,
    each (grid column, quote row) pair once across items and groups (a
    group's k quote rows of every column one of its slots names), as K2's
    bound counts J; the DFs it reads; the output. Also returns the Jt
    bytes needed and those read item by item (each item's distinct
    columns, k wide), which the kernel gathers."""
    import numpy as np
    it = tab.sitem.cpu().numpy().astype(np.int64)
    cols = [x.cpu().numpy().astype(np.int64) for x in (tab.s_idx, tab.e_idx,
                                                       tab.p_idx)]
    igrp = tab.igrp.cpu().numpy().astype(np.int64)
    ks = np.asarray(tab.ks, dtype=np.int64)
    k_of = ks[igrp]
    qrows = tab.qrows.cpu().numpy().astype(np.int64)
    qptr = tab.qptr.cpu().numpy().astype(np.int64)
    # each group's distinct columns, then each column's k_g quote rows
    gc = np.unique(np.concatenate([igrp[it] * n_grid + c for c in cols]))
    g, c = gc // n_grid, gc % n_grid
    n = ks[g]
    pos = np.arange(int(n.sum())) - np.repeat(np.cumsum(n) - n, n)
    q = qrows[np.repeat(qptr[g], n) + pos]
    j_bytes = 8 * np.unique(np.repeat(c, n) * n_quotes + q).size
    per_item = np.unique(np.concatenate([it * n_grid + c for c in cols]))
    j_item_bytes = 8 * int(k_of[per_item // n_grid].sum())
    nnz = it.shape[0]
    nbytes = (20 * nnz + 4 * (k_of.shape[0] + 1) + j_bytes
              + 8 * np.unique(np.concatenate(cols)).size + 8 * tab.n_out)
    return nbytes, 4.0 * float((k_of[it] ** 2).sum()), j_bytes, j_item_bytes


def compare_per_trade_kernels(fns, q0, device):
    """Phase 8, the per-trade rows: K1's trade-major kernel at the
    ladders' shape (``_ladder_record``) and K3 on the selected and the
    blocks path, each against its twin, with its bound and yardstick;
    returns the records (without launch counts)."""
    import torch

    from adrates_torch.ops import kernels
    lad_fn, gam_fn, blk_fn = fns
    records = []

    records.append(_ladder_record(lad_fn, q0, "flagship_v5_ladders"))
    for path, fn, replaces in (
            ("flagship_v5_gamma_256", gam_fn,
             "adrates_tpu/parallel/multibook.py:2693"),
            ("flagship_v5_gamma_blocks", blk_fn,
             "adrates_tpu/parallel/pertrade_blocks.py:316")):
        _, dfs, Jt, w = fn.prep(q0)
        t = fn.k3
        ref = kernels.pertrade_quad_form_plain(Jt, dfs, w, t)
        got = kernels.pertrade_quad_form(Jt, dfs, w, t)
        scale = max(float(r.abs().max()) for r in ref)
        err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        _check(f"{path} K3 pertrade_quad_form vs plain (abs / max|ref|)",
               err / scale, 1e-12)
        asym = sum(int((g != g.transpose(1, 2)).sum()) for g in got)
        _check(f"{path} K3 blocks bit for bit symmetric (entries that "
               f"differ from their mirror)", asym, 0)
        L, R = _k3_operands(Jt, dfs, w, t)
        Lt = L.transpose(1, 2)
        lib = torch.bmm(Lt, R)
        lib_err = max(float((lib[i0:i1, :k, :k] - r).abs().max())
                      for (i0, i1, k), r in zip(
                          zip(t.ibase[:-1], t.ibase[1:], t.ks), ref))
        _check(f"{path} K3 yardstick bmm vs plain (abs / max|ref|)",
               lib_err / scale, 1e-12)
        tm = _timings(lambda: kernels.pertrade_quad_form(Jt, dfs, w, t),
                      lambda: kernels.pertrade_quad_form_plain(Jt, dfs, w,
                                                               t),
                      lambda: torch.bmm(Lt, R))
        nbytes, flops, j_bytes, j_item = _k3_bytes_flops(t, *Jt.shape)
        bound, by = _bound(nbytes, flops, FP64_TC_FLOPS)
        n_items = t.iptr.numel() - 1
        print(f"{path} K3 pertrade_quad_form: {n_items} items in "
              f"{len(t.ks)} groups (k {min(t.ks)}..{max(t.ks)}), "
              f"{t.order.numel()} slots, {t.units.shape[0]} units in "
              f"{t.packs.shape[0]} blocks: {_fmt_tm(tm)}, bmm of padded "
              f"operands {list(L.shape)}; bound {bound * 1e3:.1f} us "
              f"({by}, {nbytes / 1e6:.3f} MB of which Jt values needed "
              f"{j_bytes / 1e6:.3f} MB, read item by item "
              f"{j_item / 1e6:.3f} MB; {flops / 1e9:.3f} GFLOP)",
              flush=True)
        records.append(dict(
            name="pertrade_quad_form", path=path, route="cuda",
            source="adrates_torch/csrc/pertrade_quad_form.cu",
            replaces=replaces, max_abs_err=err, **tm,
            library="torch.bmm of the pre-gathered, padded [items, 2K, "
                    "k_max] operands [w X; Y] and [Y; w X] (gather not "
                    "timed)",
            bound_ms=bound, bound_by=by, **_shares(bound, tm),
            jt_needed_mb=j_bytes / 1e6, jt_per_item_mb=j_item / 1e6))
        del L, R, Lt, lib, ref, got
    torch.cuda.empty_cache()
    return records


# How far a device time may exceed its event window (two samples of 30
# calls each): the kernels of a call run inside its window, so a device
# time above it is a misread trace.
DEVICE_OVER_EVENTS = 1.10


def _gate_device_times(records):
    """Every phase-8 record's device time (and its yardstick's) is at
    most its event window times ``DEVICE_OVER_EVENTS``, and present."""
    for r in records:
        for dev_key, ev_key in (("device_ms", "ms"),
                                ("library_device_ms", "library_ms"),
                                ("contraction_device_ms",
                                 "contraction_ms")):
            if r.get(ev_key) is None:
                continue
            if r[dev_key] is None:
                raise AssertionError(f"no {dev_key} for {r['name']} on "
                                     f"{r['path']}: the trace held no "
                                     f"kernel")
            _check(f"{r['path']} {r['name']} {dev_key} / {ev_key}",
                   r[dev_key] / r[ev_key], DEVICE_OVER_EVENTS)


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
    print(f"build: K1 (scenario- and trade-major, f64 and f32), K2, K3, "
          f"K4 + K5, K6 + K7, K8-K12, K13 + K14 built and loaded in "
          f"{secs:.2f} s "
          f"({kernels.library_path().name})", flush=True)

    # ---- phases 3-7b ----------------------------------------------------
    fn_o, mb_o, q_o, sh_o, info_o, info_g = run_ois_slice(device)
    fn_x, mb_x, q_x, sh_x, info_x = run_xccy_book(device)
    staged_f, fn_f, mb_f, q_f, sh_f, info_f, model_f = run_flagship_v5(
        device)
    ref_f = info_f.pop("ref")
    pt_fns, pt_infos = run_per_trade(device, staged_f, fn_f, mb_f, q_f)
    node_f = pt_infos.pop("node_inputs")
    # K13 / K14 at their calls of one warm call's first chunk: the
    # flagship_v5 staged call and the OIS slice's structured call
    ois_f = _capture_xccy(lambda: staged_f(q_f, sh_f), names=OIS)
    ois_o = _capture_xccy(lambda: fn_o(q_o, sh_o), names=OIS)
    # K8-K11 at their calls of one warm staged call's first chunk
    xccy_f = _capture_xccy(lambda: staged_f(q_f, sh_f))
    del staged_f
    # phase 7c on phase 7's model and base trades (the same seed and draw
    # order rebuild them)
    import numpy as np
    from adrates_torch.examples import flagship_v5
    base, coll = flagship_v5.build_base_trades(
        model_f, np.random.default_rng(flagship_v5.SEED))
    engine = run_engine(device, model_f, base, coll)
    solve_e = engine.pop("solve_inputs")
    splines, info_s, fit_inputs, xccy_s, solve_s = run_flagship_v5_splines(
        device, info_f, pt_infos["gamma_256"])
    hostapi, book_args = run_host_api(device, model_f, mb_f)
    # phase 7g on phase 7's model: config 2's OIS and a live basis swap
    analytics = run_ois_analytics(
        device, model_f, next(t for name, t, _ in _route_trades(
            base, coll, model_f.value_dt) if name == "xccy_basis"))
    # ---- phase 7f-c (before phase 8, which times its K1-f32 inputs) ------
    f32, lad32_fn, info32 = run_f32_ladders(
        device, mb_f, q_f, pt_fns[0],
        statistics.median(pt_infos["ladders"]["warm_ms"]))
    for path, info in (("ois_slice", info_o), ("ois_slice_generic", info_g),
                       ("ois_xccy_book", info_x), ("flagship_v5", info_f)):
        for name in ("pvs_sweep", "gamma_quad_form_grouped"):
            if info[name] <= 0:
                raise AssertionError(f"{name} was not launched on the "
                                     f"{path} path")
        _solve_launches(path, info)
    for path, info in (("ois_xccy_book", info_x), ("flagship_v5", info_f)):
        _xccy_launches(path, info)
    _xccy_launches("flagship_v5_ladders", pt_infos["ladders"], hess=False)

    # ---- phase 8 (before 7f-a/b: no process group, no spawned rank) ------
    infos = dict(ois_slice=info_o, ois_xccy_book=info_x, flagship_v5=info_f)
    records = []
    for path, args in (("ois_slice", (fn_o, mb_o, q_o, sh_o)),
                       ("ois_xccy_book", (fn_x, mb_x, q_x, sh_x)),
                       ("flagship_v5", (fn_f, mb_f, q_f, sh_f))):
        records += compare_kernels(path, *args, device,
                                   chunk=infos[path]["chunk"])
    records += compare_per_trade_kernels(pt_fns, q_f, device)
    records.append(compare_book_kernel(*book_args))
    records.append(_ladder_record(lad32_fn, q_f, "flagship_v5_ladders_f32"))
    del lad32_fn
    records += compare_solve_kernels("engine_config2", solve_e)
    records += compare_solve_kernels(
        "flagship_v5_splines", solve_s,
        label="the spline cell's staged call: regions A and C2's torch.func "
              "towers over its OIS stage, whose fitted members keep them "
              "(on FLAT_FWD the stage takes K13 / K14)")
    records += compare_ois_kernels("flagship_v5", ois_f)
    records += compare_ois_kernels("ois_slice", ois_o)
    records += compare_fitted_kernels(fit_inputs)
    records += compare_xccy_kernels("flagship_v5", xccy_f)
    records += compare_xccy_kernels("flagship_v5_gamma_256", node_f,
                                    names=NODE)
    for k, inputs in enumerate(xccy_s):
        records += compare_xccy_kernels("flagship_v5_splines", inputs,
                                        stage=k)
    del solve_e, solve_s, fit_inputs, xccy_f, xccy_s, node_f, ois_f, ois_o
    infos.update(flagship_v5_ladders=pt_infos["ladders"],
                 flagship_v5_gamma_256=pt_infos["gamma_256"],
                 flagship_v5_gamma_blocks=pt_infos["blocks"],
                 single_curve_book=book_args[4],
                 flagship_v5_ladders_f32=info32,
                 engine_config2=engine["config2"]["launches"],
                 flagship_v5_splines_gamma_256=info_s["gamma_256"],
                 flagship_v5_splines=info_s,
                 **{f"flagship_v5_splines_{r}": info_s
                    for r in ("A", "C1", "C2")})
    for r in records:
        info = infos[r["path"]]
        r["launches"] = info[r["name"]]
        r["launches_per_call"] = info[r["name"]] / info["calls"]
    _gate_device_times(records)

    # ---- phase 7f-a/b ----------------------------------------------------
    single = {k: statistics.median(pt_infos[k]["warm_ms"])
              for k in ("ladders", "gamma_256", "blocks")}
    single.update(multibook=statistics.median(info_f["warm_ms"]),
                  book=book_args[4]["warm_ms"]["median"])
    sharded = run_sharded(device, mb_f, q_f, sh_f, ref_f, pt_fns, model_f,
                          single)
    sharded["f32_ladders"] = f32
    del ref_f
    torch.cuda.synchronize()
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)

    # ---- phase 9 -------------------------------------------------------
    card = _card_line()
    for r in records:
        where = r["path"] if r.get("stage") is None \
            else f"{r['path']} stage {r['stage']}"
        print(f"bound {where} {r['name']}: device {r['device_ms']:.4f} "
              f"ms (events {r['ms']:.4f} ms) against {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), share {r['share_of_bound']:.3f} (by "
              f"events {r['share_of_bound_events']:.3f}), "
              f"{r['launches_per_call']:g} launches per call"
              + ("" if r.get("on_path", True) else " (a shape off the main "
                 "path)") + f"; card {card}")
    print(json.dumps({"engine": engine}))
    print(json.dumps({"splines": splines}))
    print(json.dumps({"hostapi": hostapi}))
    print(json.dumps({"analytics": analytics}))
    print(json.dumps({"sharded": sharded}))
    print(json.dumps({"pertrade": {
        k: dict(device_ops=pt_infos[k]["device_ops"],
                device_ms=pt_infos[k]["device_ms"],
                warm_ms=pt_infos[k]["warm_ms"], calls=pt_infos[k]["calls"],
                launches={n: pt_infos[k][n] for n in NODE})
        for k in ("gamma_256", "blocks")}}))
    print(json.dumps({"kernels": records}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
