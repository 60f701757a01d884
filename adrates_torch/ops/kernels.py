"""The hand-written CUDA kernels of the book path, their plain torch
twins, the static tables they run on, and the build that binds them.

K1 ``pvs_sweep`` (``csrc/pvs_sweep.cu``) replaces
``adrates_tpu/parallel/multibook.py:_pvs_sweep`` (:1782, the gather and
row/trade sums) with a scenario-major kernel writing [S, B], and the
per-trade ladder contraction of ``make_per_trade_delta_fn`` (:2842)
with a trade-major kernel writing [B, N] (``trade_major=True``, launch
plan :func:`sweep_plan`). K2 ``gamma_quad_form_grouped``
(``csrc/gamma_quad_form.cu``) replaces ``_gamma_quad_form_grouped``
(:1660, the trip term). K3 ``pertrade_quad_form``
(``csrc/pertrade_quad_form.cu``) replaces the per-trade quad forms of
``adrates_tpu/parallel/pertrade_blocks.py`` (:316-363) and
``multibook.py:_sel_gamma_kernel`` (:2693-2753). K4 ``pv01_solve`` and
K5 ``pv01_solve_t`` (``csrc/pv01_solve.cu``) replace the ``solve`` and
``transpose_solve`` of the custom linear solve in
``adrates_tpu/ops/bootstrap.py:bootstrap_ois`` (:332-341), the OIS
pv01 chain (I - A) x = b and its transpose; ``ops/linear_solve`` makes
them the derivatives of each other. K6 ``fitted_eval`` (with its
tangent mode ``fitted_eval_jvp`` and its linear core ``fitted_rows``)
and K7 ``fitted_rows_t`` (``csrc/fitted_rows.cu``) replace the fitted
schemes' fit and evaluation at static queries
(``adrates_tpu/ops/interpolation.py`` ``interp_fit`` :350 and
``interp_df`` :375, as ``adrates_tpu/parallel/curve_batching.py:
stage_rows`` :320 calls them): a stage's fitted members, stacked, from
their DFs to the queries' DFs in one launch, its directional
derivatives in one more, and the transpose of the linear map at its
core (from the transformed knot values and PCHIP slopes to the
Hermite rows); ``ops/fitted_rows`` makes them the derivatives of each
other. K8
``xccy_stage_jvp``, K9 ``xccy_legs_jvp``, K10 ``xccy_stage_hess`` and
K11 ``xccy_legs_hess`` (``csrc/xccy_stage.cu``) replace the
``torch.func`` towers over an XCCY stage of the structured risk pass
(``adrates_tpu/parallel/structured_risk.py`` :321 and :457-603 over
``curve_batching.py`` :265-319, ``ops/xccy_bootstrap.py`` :78 and
``ops/pricers.py`` :102) on ``ops/xccy_stage.XccyStageTables``: K8 /
K10 evaluate the stage in dual or hyper-dual arithmetic, split at its
node DFs (the pair-independent work once a block); K9 / K11 evaluate the
calibration legs' flows once a (scenario, member), collapse their
gradients and gpv-weighted Hessian onto the domestic grid and take each
direction or pair as a dot product. K12 ``xccy_stage_node_hess``
(the same file) replaces the ``torch.func`` towers of the per-trade
second-order tensors of such a stage (``make_pertrade_tensors``, after
``adrates_tpu/parallel/structured_risk.py`` :900-1010): the node DFs
as outputs, their first tangents and each pair's second derivatives,
which the caller contracts with the rows' derivatives in the nodes; a
chain a warp, its lanes on the chain points, in two launches (the
pair-independent chains once a (scenario, member), then a pair a
warp). Their module holds their plain
versions. K13 ``ois_stage_jvp`` and K14 ``ois_stage_hess``
(``csrc/ois_stage.cu``) replace the ``torch.func`` towers over an OIS
stage of the structured risk pass (region A's OIS pass and
``term2_ois``, ``adrates_tpu/parallel/structured_risk.py`` :296-318 and
:604-645 over ``ops/bootstrap.py:213``) on
``ops/ois_stage.OisStageTables``: a block a (scenario, member), a lane
of its first warp a quote direction walking the bootstrap's points in
dual numbers, K14 its adjoint in reverse order in dual numbers (forward
over reverse, split at the node DFs); ``ops/ois_stage`` holds their
plain versions. K1-K3 are
forward-only (their derivatives are closed form elsewhere), and so are
K8-K14 (derivatives themselves). All fourteen
are f64; K1
also has f32 instantiations for the f32 ladders
(``make_per_trade_delta_fn(dtype=torch.float32)``, the JAX package's
``dtype`` option at ``multibook.py:2825-2829``), which read, sum and
write f32. Each source file says what bounds it on the card and how its
design answers that.

Tables: each kernel runs on static tables built once per book, on the
book's device, by :func:`sweep_tables` (K1: a per-trade CSR of live
(column, weight) slots plus each trade block's distinct value rows),
:func:`quad_tables` (K2: the trip groups, the launch's work list of
group row blocks, and the table that sums the groups' blocks into G),
:func:`pertrade_tables` (K3: groups of quote rows, their trades' slot
CSR and the launch's work list of units packed into blocks) and
:func:`chain_tables` (K4/K5: an OIS plan's previous-point links, once
per plan), ``ops/xccy_stage.stage_tables`` (K8-K12: an XCCY
stage's chain, plans and legs, once per stage) and
``ops/ois_stage.stage_tables`` (K13 / K14: an OIS stage's chain and rows,
once per stage). The plain twins read
the same tables.

Dispatch: a wrapper given CPU tensors runs the plain twin; given CUDA
tensors it launches the kernel or raises. Nothing falls back. Each
wrapper counts its kernel launches in ``<wrapper>.launches`` (a plain
int; the plain path never touches it); K4's and K5's also count their
calls on either path in ``<wrapper>.calls``.

Build: at first use on a CUDA tensor, one ``nvcc`` per ``*.cu`` under
``adrates_torch/csrc`` (all started together) compiles it for ``sm_90a``,
and one more links them into a shared library with a plain C interface
under ``adrates_torch/_build``, named by a hash of the sources and flags,
which ``ctypes`` loads. Nothing is built at import.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import math
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from ..utils.error import LibError
from . import ois_stage, xccy_stage


_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-Xcompiler", "-fPIC"]

# trades per K1 thread block (csrc/pvs_sweep.cu kTB)
SWEEP_BLOCK = 32
# the most quote rows one K2 work item gathers (csrc/gamma_quad_form.cu
# kKMax): a trip group up to this wide is one item, a wider one is split
# into pairs of chunks of QUAD_ITEM_K // 2 rows
QUAD_ITEM_K = 80

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "pvs_sweep_f64": [_P, _I, _I, _P, _P, _P, _P, _P, _I, _P, _P],
    "pvs_sweep_f32": [_P, _I, _I, _P, _P, _P, _P, _P, _I, _P, _P],
    "pvs_sweep_tm_f64": [_P, _I, _I, _I, _P, _P, _P, _P, _P, _I, _P, _P],
    "pvs_sweep_tm_f32": [_P, _I, _I, _I, _P, _P, _P, _P, _P, _I, _P, _P],
    "gamma_groups_f64": [_P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                         _P, _I, _I, _I, _P, _P, _P],
    "gamma_reduce_f64": [_P, _I, _I, _P, _P, _I, _P, _P],
    "pertrade_quad_f64": [_P, _I, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P,
                          _P, _P, _P],
    "pv01_solve_f64": [_P, _P, _P, _I, _I, _I, _P, _P],
    "pv01_solve_t_f64": [_P, _P, _P, _I, _I, _I, _P, _P],
    "fitted_rows_f64": [_P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                        _P, _P, _P],
    "fitted_rows_t_f64": [_P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                          _P, _P, _P, _I, _P, _P],
    "fitted_eval_f64": [_P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                        _P, _P, _P, _P, _P],
    "fitted_kernel_info": [_I, _I, _I, _I, _I, _I, _P],
    "fitted_eval_jvp_f64": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                            _P, _P, _P, _P, _P, _P, _P, _P, _P],
    "xccy_stage_jvp_f64": [_P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P],
    "xccy_legs_jvp_f64": [_P, _I, _I, _P, _P, _P, _P, _P],
    "xccy_stage_hess_f64": [_P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                            _P, _P],
    "xccy_legs_hess_f64": [_P, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    "xccy_stage_node_hess_f64": [_P, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                                 _P, _P, _P, _P, _I, _P],
    "xccy_kernel_info": [_P, _I, _I, _I, _P],
    "ois_stage_jvp_f64": [_P, _I, _P, _P, _P, _P, _P, _P],
    "ois_stage_hess_f64": [_P, _I, _P, _P, _P, _P, _P],
    "ois_kernel_info": [_P, _I, _P],
}

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (put it on PATH or set CUDA_HOME)")


def library_path() -> Path:
    """Where the kernels' shared library for the current sources lives."""
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for src in sorted([*_CSRC.glob("*.cu"), *_CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _BUILD / f"libadrates_kernels_{h.hexdigest()[:16]}.so"


def build_kernels() -> float:
    """Compile (if needed) and load the kernels; returns the seconds it
    took. Each source compiles in its own ``nvcc`` process, all started
    together, then one link. Raises if nvcc fails."""
    global _lib
    t0 = time.perf_counter()
    if _lib is None:
        so = library_path()
        if not so.exists():
            _BUILD.mkdir(parents=True, exist_ok=True)
            tag = f"{os.getpid()}"
            srcs = sorted(_CSRC.glob("*.cu"))
            objs = [_BUILD / f"{s.stem}.{tag}.o" for s in srcs]
            procs = [subprocess.Popen(
                [_nvcc(), *_NVCC_FLAGS, "-c", "-o", str(o), str(s)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                for s, o in zip(srcs, objs)]
            errs = []
            for s, p in zip(srcs, procs):
                out, err = p.communicate()
                if p.returncode != 0:
                    errs.append(f"{s.name} ({p.returncode}):\n{out}\n{err}")
            if errs:
                raise RuntimeError("nvcc failed: " + "\n".join(errs))
            tmp = so.with_suffix(f".{tag}.tmp")
            res = subprocess.run([_nvcc(), *_NVCC_FLAGS, "-shared", "-o",
                                  str(tmp), *map(str, objs)],
                                 capture_output=True, text=True)
            for o in objs:
                o.unlink(missing_ok=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                                   f"{res.stdout}\n{res.stderr}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return time.perf_counter() - t0


def _check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def _need(t: torch.Tensor, name: str, dtype, ndim: int, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{ndim} dims")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stream(dev) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _ptr(counts: torch.Tensor) -> torch.Tensor:
    """int32 CSR pointer [n + 1] of per-segment counts."""
    out = torch.zeros(counts.shape[0] + 1, dtype=torch.int64,
                      device=counts.device)
    torch.cumsum(counts, 0, out=out[1:])
    return out.to(torch.int32)


# ---------------------------------------------------------------------------
# K1: per-trade PV sweep
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SweepTables:
    """K1's tables: a per-trade CSR of live (column, weight) slots over
    the [M, S] value table, blocked by ``SWEEP_BLOCK`` consecutive trades
    (the book's own order). Block ``k`` stages the distinct value rows
    ``brow[bptr[k]:bptr[k + 1]]`` (ascending); a slot names its row by
    its index in that list (``slot_row``, ascending within each trade)."""
    n_trades: int
    n_cols: int
    tptr: torch.Tensor               # [B + 1] int32
    slot_row: torch.Tensor           # [nnz] int32
    slot_w: torch.Tensor             # [nnz] f64 (f32: sweep_tables_as)
    bptr: torch.Tensor               # [n_blocks + 1] int32
    brow: torch.Tensor               # [n_rows] int32

    def slot_trade(self) -> torch.Tensor:
        """[nnz] int64: each slot's trade."""
        return torch.repeat_interleave(
            torch.arange(self.n_trades, device=self.tptr.device),
            (self.tptr[1:] - self.tptr[:-1]).long())

    def slot_col(self) -> torch.Tensor:
        """[nnz] int64: each slot's column of the value table."""
        blk = self.slot_trade() // SWEEP_BLOCK
        return self.brow.long()[self.bptr.long()[blk]
                                + self.slot_row.long()]


def sweep_tables(trade: torch.Tensor, col: torch.Tensor, w: torch.Tensor,
                 n_trades: int, n_cols: int) -> SweepTables:
    """K1's tables from flat slots (trade, column, weight) in any order:
    dead slots (w == 0) dropped, a trade's duplicate columns merged (their
    weights summed in slot order), on the slots' device, vectorised."""
    dev = w.device
    live = w != 0.0
    trade, col, w = trade[live].long(), col[live].long(), w[live]
    key = trade * n_cols + col
    key, order = torch.sort(key, stable=True)
    w = w[order]
    n = key.shape[0]
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = key[1:] != key[:-1]
    starts = torch.nonzero(first).flatten()
    lens = torch.diff(starts, append=torch.tensor([n], device=dev))
    wsum = w[starts].clone()
    for r in range(1, int(lens.max()) if n else 0):
        more = lens > r
        wsum[more] += w[starts[more] + r]
    key = key[starts]
    trade, col = key // n_cols, key % n_cols
    n_blocks = -(-n_trades // SWEEP_BLOCK)
    blk = trade // SWEEP_BLOCK
    bkey, brow_of = torch.unique(blk * n_cols + col, sorted=True,
                                 return_inverse=True)
    bptr = _ptr(torch.bincount(bkey // n_cols, minlength=n_blocks))
    return SweepTables(
        n_trades=n_trades, n_cols=n_cols,
        tptr=_ptr(torch.bincount(trade, minlength=n_trades)),
        slot_row=(brow_of - bptr.long()[blk]).to(torch.int32),
        slot_w=wsum.to(torch.float64).contiguous(),
        bptr=bptr, brow=(bkey % n_cols).to(torch.int32))


def pvs_sweep_plain(vT: torch.Tensor, tab: SweepTables,
                    trade_major: bool = False) -> torch.Tensor:
    """Plain twin of K1, written from ``_pvs_sweep``: the [S, B] trade
    PVs, sum over each trade's slots of w · vT[col, :], from the [M, S]
    value table and the tables of :func:`sweep_tables`, in the dtype of
    ``vT`` (the tables' weights are in that dtype too); with
    ``trade_major`` the same sums as [B, S] (the ladders' layout)."""
    S = vT.shape[1]
    trade, col, w = tab.slot_trade(), tab.slot_col(), tab.slot_w
    out = torch.zeros((tab.n_trades, S), dtype=vT.dtype, device=vT.device)
    # bound the [chunk, S] gathered temporary near 200 MB f64
    chunk = max(1, int(2.5e7 // max(S, 1)))
    for lo in range(0, w.shape[0], chunk):
        sl = slice(lo, lo + chunk)
        out.index_add_(0, trade[sl], w[sl, None] * vT[col[sl]])
    return out if trade_major else out.T.contiguous()


def sweep_tables_as(tab: SweepTables, dtype) -> SweepTables:
    """``tab`` with its slot weights cast to ``dtype`` (the f32 sweep's
    tables; the index tables are shared)."""
    return dataclasses.replace(tab, slot_w=tab.slot_w.to(dtype))


# K1's entry points (scenario-major, trade-major), the elements of a
# 16-byte piece and the pieces a lane owns in a trade-major pass, by dtype
_SWEEP_ENTRY = {torch.float64: ("pvs_sweep_f64", "pvs_sweep_tm_f64", 2, 3),
                torch.float32: ("pvs_sweep_f32", "pvs_sweep_tm_f32", 4, 2)}
# the trade-major kernel's ring (csrc/pvs_sweep.cu kTMStages, kTMRows):
# at most 98 KB at any N, so two blocks of 512 threads stay on an SM
SWEEP_STAGES = 2
SWEEP_ROWS = 32


@dataclasses.dataclass(frozen=True)
class SweepPlan:
    """The trade-major K1 launch for ``n_cols`` output columns: ``passes``
    column passes of up to ``width`` columns (grid.y), ``pieces`` 16-byte
    pieces a lane of ``vec`` elements each; the value table's row stride
    ``ld`` (whole pieces); a stage row of ``pitch`` elements and
    ``smem_bytes`` for the ring of ``SWEEP_STAGES`` stages of
    ``SWEEP_ROWS`` rows."""
    width: int
    passes: int
    pieces: int
    vec: int
    ld: int
    pitch: int
    smem_bytes: int


def sweep_plan(n_cols: int, dtype) -> SweepPlan:
    """The trade-major K1 launch plan (see :class:`SweepPlan`): a pass is
    32 lanes x ``pieces`` x ``vec`` columns (192 f64, 256 f32), so at
    N <= width one pass reads the slot tables once; a stage row holds the
    widest pass."""
    if dtype not in _SWEEP_ENTRY:
        raise TypeError(f"no K1 for dtype {dtype}")
    _, _, vec, pieces = _SWEEP_ENTRY[dtype]
    size = torch.empty((), dtype=dtype).element_size()
    width = 32 * pieces * vec
    n = int(n_cols)
    ld = -(-n // vec) * vec
    pitch = min(ld, width)
    return SweepPlan(width=width, passes=-(-n // width), pieces=pieces,
                     vec=vec, ld=ld, pitch=pitch,
                     smem_bytes=SWEEP_STAGES * SWEEP_ROWS * pitch * size)


def pvs_sweep(vT: torch.Tensor, tab: SweepTables,
              trade_major: bool = False) -> torch.Tensor:
    """K1: [S, B] trade PVs (see :func:`pvs_sweep_plain`) in one launch,
    in f64 or in f32 (``vT``'s dtype, which the tables' weights must
    share: :func:`sweep_tables_as`; the f32 kernel reads, sums and writes
    f32). With ``trade_major`` the trade-major kernel writes the [B, S]
    sums itself (the ladders: S = N quotes; :func:`sweep_plan`). ``vT`` is
    [M, S] with unit column stride; a 16-byte aligned row stride that
    holds whole 16-byte pieces is taken as it is, else the rows are
    copied into such a buffer first."""
    if not vT.is_cuda:
        return pvs_sweep_plain(vT, tab, trade_major)
    dev = vT.device
    M, S = vT.shape
    if vT.dtype not in _SWEEP_ENTRY:
        raise TypeError(f"vT has dtype {vT.dtype}, expected torch.float64 "
                        f"or torch.float32")
    entry, entry_tm, vec, _ = _SWEEP_ENTRY[vT.dtype]
    if M != tab.n_cols:
        raise ValueError(f"vT has {M} rows, the tables {tab.n_cols}")
    if vT.stride(1) != 1 or vT.stride(0) % vec or vT.data_ptr() % 16:
        buf = torch.empty((M, S + (-S) % vec), dtype=vT.dtype, device=dev)
        buf[:, :S] = vT
        vT = buf[:, :S]
    for name in ("tptr", "slot_row", "bptr", "brow"):
        _need(getattr(tab, name), name, torch.int32, 1, dev)
    _need(tab.slot_w, "slot_w", vT.dtype, 1, dev)
    B = tab.n_trades
    out = torch.empty((B, S) if trade_major else (S, B), dtype=vT.dtype,
                      device=dev)
    if S == 0 or B == 0:
        return out
    build_kernels()
    ptrs = (tab.tptr.data_ptr(), tab.slot_row.data_ptr(),
            tab.slot_w.data_ptr(), tab.bptr.data_ptr(), tab.brow.data_ptr(),
            B, out.data_ptr(), _stream(dev))
    if trade_major:
        plan = sweep_plan(S, vT.dtype)
        _check(getattr(_lib, entry_tm)(vT.data_ptr(), vT.stride(0), S,
                                       plan.pitch, *ptrs), entry_tm)
    else:
        _check(getattr(_lib, entry)(vT.data_ptr(), vT.stride(0), S, *ptrs),
               entry)
    pvs_sweep.launches += 1
    return out


pvs_sweep.launches = 0


# ---------------------------------------------------------------------------
# K2: grouped term-1 quad form
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class QuadTables:
    """K2's tables. Group g (in the caller's order) owns trips
    ``tptr[g]:tptr[g + 1]`` of the concatenated (s_idx, e_idx, p_idx, w),
    sorted by column, and quote rows ``rows[rptr[g]:rptr[g + 1]]``; its
    symmetric k x k block lands in the per-scenario partial vector at
    ``poff[g]`` (row-major). ``items`` is the launch's work list, largest
    first: a row (g, a0, na, b0, nb) covers the part of group g's block
    at its rows [a0, a0 + na) x [b0, b0 + nb) and its mirror, or with
    nb = 0 the symmetric part [a0, a0 + na)^2; together a group's items
    cover its block once. G entry e = i * N + j is the sum of the
    partials ``red_src[red_ptr[e]:red_ptr[e + 1]]``, in group order."""
    n_quotes: int
    n_part: int
    item_rows: int                   # most rows an item stages (8-padded)
    items: torch.Tensor              # [n_items, 5] int32
    tptr: torch.Tensor               # [n_groups + 1] int32
    s_idx: torch.Tensor              # [T_all] int32
    e_idx: torch.Tensor
    p_idx: torch.Tensor
    w: torch.Tensor                  # [T_all] f64
    rptr: torch.Tensor               # [n_groups + 1] int32
    rows: torch.Tensor               # [K_all] int32
    poff: torch.Tensor               # [n_groups] int32
    red_ptr: torch.Tensor            # [N * N + 1] int32
    red_src: torch.Tensor            # [n_part] int32

    @property
    def n_groups(self) -> int:
        return self.poff.shape[0]


def _quad_items(ks: np.ndarray, ts: np.ndarray) -> np.ndarray:
    """[n_items, 5] (g, a0, na, b0, nb): one symmetric item per group up
    to QUAD_ITEM_K rows wide; a wider group's rows in chunks of
    QUAD_ITEM_K // 2, one item per chunk pair (a <= b). Ordered by rows
    gathered, then trips, largest first."""
    h = QUAD_ITEM_K // 2
    items = []
    for g, k in enumerate(ks.tolist()):
        if k <= QUAD_ITEM_K:
            items.append((g, 0, k, 0, 0))
            continue
        lo = list(range(0, k, h))
        for i, a in enumerate(lo):
            na = min(h, k - a)
            items.append((g, a, na, 0, 0))
            items += [(g, a, na, b, min(h, k - b)) for b in lo[i + 1:]]
    it = np.asarray(items, dtype=np.int64).reshape(-1, 5)
    return it[np.lexsort((-ts[it[:, 0]], -(it[:, 2] + it[:, 4])))]


def quad_tables(groups: Sequence[dict], n_quotes: int,
                device=None) -> QuadTables:
    """K2's tables from the trip groups (dicts of ``s_idx``, ``e_idx``,
    ``p_idx``, ``rows`` and ``w``, numpy or tensors), built on the host
    and placed on ``device`` (default: the groups' own)."""
    def host(a):
        return a.detach().cpu().numpy() if torch.is_tensor(a) \
            else np.asarray(a)

    if device is None:
        device = groups[0]["w"].device if groups and torch.is_tensor(
            groups[0]["w"]) else torch.device("cpu")
    N = int(n_quotes)
    cols = {k: [] for k in ("s_idx", "e_idx", "p_idx", "w")}
    rows, ks, ts, ents = [], [], [], []
    poff = 0
    for g in groups:
        s, e, p = (host(g[k]).astype(np.int64)
                   for k in ("s_idx", "e_idx", "p_idx"))
        o = np.lexsort((p, s, e))               # by e, then s, then p
        for k, a in (("s_idx", s), ("e_idx", e), ("p_idx", p),
                     ("w", host(g["w"]).astype(np.float64))):
            cols[k].append(a[o])
        r = host(g["rows"]).astype(np.int64)
        rows.append(r)
        ks.append(r.shape[0])
        ts.append(s.shape[0])
        ents.append((r[:, None] * N + r[None, :]).ravel())
        poff += r.shape[0] ** 2
    k_arr = np.asarray(ks, dtype=np.int64)
    ent = np.concatenate(ents) if ents else np.zeros(0, dtype=np.int64)
    red_src = np.argsort(ent, kind="stable")   # group order within entry

    def cat(parts, dtype):
        return np.concatenate(parts).astype(dtype) if parts \
            else np.zeros(0, dtype=dtype)

    def ptr(counts):
        return np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    t_arr = np.asarray(ts, dtype=np.int64)
    items = _quad_items(k_arr, t_arr)
    return QuadTables(
        n_quotes=N, n_part=int(poff),
        item_rows=int(((items[:, 2] + 7) // 8 * 8
                       + (items[:, 4] + 7) // 8 * 8).max())
        if items.size else 0,
        items=dev(items.astype(np.int32)),
        tptr=dev(ptr(t_arr)),
        s_idx=dev(cat(cols["s_idx"], np.int32)),
        e_idx=dev(cat(cols["e_idx"], np.int32)),
        p_idx=dev(cat(cols["p_idx"], np.int32)),
        w=dev(cat(cols["w"], np.float64)),
        rptr=dev(ptr(k_arr)), rows=dev(cat(rows, np.int32)),
        poff=dev(ptr(k_arr ** 2)[:-1]),
        red_ptr=dev(ptr(np.bincount(ent, minlength=N * N))),
        red_src=dev(red_src.astype(np.int32)))


def gamma_quad_form_grouped_plain(J: torch.Tensor, dfs: torch.Tensor,
                                  tab: QuadTables) -> torch.Tensor:
    """Plain twin of K2, written from ``_gamma_quad_form_grouped``:
    J [S, N, n_grid], dfs [S, n_grid] and the tables of
    :func:`quad_tables` -> the trip term of Jᵀ·H_agg·J, [S, N, N].

    A trip's value (a/b - 1) c has the second differential
    2 du (dc - (c/b) db) with du = (da - (a/b) db)/b, so its block is
    the rank-2 form w (X Yᵀ + Y Xᵀ) with X = (Ja - (a/b) Jb)/b and
    Y = Jc - (c/b) Jb. That is the JAX package's four-product form
    (f_ab, f_ac, f_bc, f_bb) regrouped: the near-cancelling Ja/Jb terms
    of a short accrual period cancel once, in X, instead of across four
    accumulated products. Each group's block goes to the partial vector,
    and the reduction table sums the partials into G."""
    S, N, n_grid = J.shape
    Jf = J.reshape(S, -1)
    part = torch.empty((S, tab.n_part), dtype=J.dtype, device=J.device)
    tptr, rptr, poff = (x.tolist() for x in (tab.tptr, tab.rptr, tab.poff))
    for g in range(tab.n_groups):
        ts = slice(tptr[g], tptr[g + 1])
        s_i, e_i, p_i = (x[ts].long() for x in
                         (tab.s_idx, tab.e_idx, tab.p_idx))
        rows = tab.rows[rptr[g]:rptr[g + 1]].long()
        k = rows.shape[0]
        a, b, c = dfs[:, s_i], dfs[:, e_i], dfs[:, p_i]      # [S, T_g]
        base = rows[:, None] * n_grid
        Ja = Jf[:, base + s_i[None, :]]                       # [S, k, T_g]
        Jb = Jf[:, base + e_i[None, :]]
        Jc = Jf[:, base + p_i[None, :]]
        X = (Ja - (a / b)[:, None, :] * Jb) * (1.0 / b)[:, None, :]
        Y = Jc - (c / b)[:, None, :] * Jb
        Z = (X * tab.w[ts][None, None, :]) @ Y.transpose(1, 2)
        part[:, poff[g]:poff[g] + k * k] = (Z + Z.transpose(1, 2)) \
            .reshape(S, k * k)
    ent = torch.repeat_interleave(
        torch.arange(N * N, device=J.device),
        (tab.red_ptr[1:] - tab.red_ptr[:-1]).long())
    G = torch.zeros((S, N * N), dtype=J.dtype, device=J.device)
    G.index_add_(1, ent, part[:, tab.red_src.long()])
    return G.reshape(S, N, N)


def gamma_quad_form_grouped(J: torch.Tensor, dfs: torch.Tensor,
                            tab: QuadTables) -> torch.Tensor:
    """K2: the [S, N, N] trip term (see
    :func:`gamma_quad_form_grouped_plain`) in two launches: every
    (item, scenario) block on the FP64 tensor cores into the partial
    buffer, then the fixed-order sum of the partials into G (which also
    writes G's zeros). Groups of any width: a wide one runs as several
    items."""
    if not J.is_cuda:
        return gamma_quad_form_grouped_plain(J, dfs, tab)
    dev = J.device
    _need(J, "J", torch.float64, 3, dev)
    _need(dfs, "dfs", torch.float64, 2, dev)
    S, N, n_grid = J.shape
    if tuple(dfs.shape) != (S, n_grid):
        raise ValueError(f"dfs {tuple(dfs.shape)} vs J {tuple(J.shape)}")
    if N != tab.n_quotes:
        raise ValueError(f"J has {N} quote rows, the tables "
                         f"{tab.n_quotes}")
    n_items = tab.items.shape[0]
    if n_items > 65535:
        raise ValueError(f"{n_items} work items exceed one launch's grid y")
    _need(tab.items, "items", torch.int32, 2, dev)
    for name in ("tptr", "s_idx", "e_idx", "p_idx", "rptr", "rows",
                 "poff", "red_ptr", "red_src"):
        _need(getattr(tab, name), name, torch.int32, 1, dev)
    _need(tab.w, "w", torch.float64, 1, dev)
    G = torch.empty((S, N, N), dtype=torch.float64, device=dev)
    if S == 0:
        return G
    build_kernels()
    stream = _stream(dev)
    part = torch.empty((S, tab.n_part), dtype=torch.float64, device=dev)
    if n_items:
        _check(_lib.gamma_groups_f64(
            J.data_ptr(), dfs.data_ptr(), S, N, n_grid,
            tab.items.data_ptr(), tab.tptr.data_ptr(),
            tab.s_idx.data_ptr(), tab.e_idx.data_ptr(),
            tab.p_idx.data_ptr(), tab.w.data_ptr(), tab.rptr.data_ptr(),
            tab.rows.data_ptr(), n_items, tab.item_rows, tab.n_part,
            tab.poff.data_ptr(), part.data_ptr(), stream),
            "gamma_groups_f64")
        gamma_quad_form_grouped.launches += 1
    _check(_lib.gamma_reduce_f64(part.data_ptr(), S, tab.n_part,
                                 tab.red_ptr.data_ptr(),
                                 tab.red_src.data_ptr(), N * N,
                                 G.data_ptr(), stream), "gamma_reduce_f64")
    gamma_quad_form_grouped.launches += 1
    return G


gamma_quad_form_grouped.launches = 0


# ---------------------------------------------------------------------------
# K3: per-trade term-1 quad form
# ---------------------------------------------------------------------------

# K3's launch geometry (csrc/pertrade_quad_form.cu): warps per block, the
# most 16 x 8 tiles a warp accumulates, slots per staged segment, the most
# rows a block stages (the widest item one unit takes whole is 184 rows:
# its 144 tiles fit 16 warps of 9), the widest and the narrowest
# chunk a cut item's units pair (96 + 96 rows staged); the SMs of an H100
# and the least work (pertrade_work) the host balances units to
PERTRADE_WARPS = 16
PERTRADE_TPW = 9
PERTRADE_SEG = 16
PERTRADE_ROWS = 192
PERTRADE_CHUNK = 96
PERTRADE_CHUNK_MIN = 32
PERTRADE_SMS = 132
PERTRADE_MIN_WORK = 1024


@dataclasses.dataclass(frozen=True)
class PertradeTables:
    """K3's tables. Group g has quote rows ``qrows[qptr[g]:qptr[g + 1]]``
    (k_g of them) and items (trades) ``ibase[g]:ibase[g + 1]``; item i
    owns slots ``iptr[i]:iptr[i + 1]`` of (s_idx, e_idx, p_idx), which are
    the caller's slots reordered by item (``order``: the caller's index of
    each), and its k x k block lands at the sum of the earlier items' k^2
    in the flat output (``n_out`` values). Jt needs ``n_cols`` columns at least (the highest
    quote row + 1).

    The launch's work list: ``units`` [n_units, 13] (item, a0, na, b0,
    nb, row_off, warp0, n_warps, lo, hi, qoff, k, ioff) each cover the
    item's rows [a0, a0 + na) against [b0, b0 + nb) and the mirror, or
    with nb = 0 the symmetric block of [a0, a0 + na), staged from block
    row ``row_off`` (chunk a padded to 16 rows, chunk b to 8) on warps
    [warp0, warp0 + n_warps), with the item's slots [lo, hi), its group's
    rows at ``qrows[qoff:qoff + k]`` and its block at ``ioff``; together
    an item's units cover its block once. ``packs`` [n_packs, 5] (first
    unit, end unit, segments, staged rows, first row in ``prows``) are the
    blocks, largest first; ``prows`` [sum of staged rows, 2] holds each
    staged row's Jt column (-1 for padding) and its unit in the pack;
    ``rows_max`` the most rows a pack stages."""
    ks: tuple                        # k_g per group
    ibase: tuple                     # [n_groups + 1] item ranges
    n_out: int
    n_cols: int
    rows_max: int
    order: torch.Tensor              # [n_slots] int64
    s_idx: torch.Tensor              # [n_slots] int32, by item
    e_idx: torch.Tensor
    p_idx: torch.Tensor
    sitem: torch.Tensor              # [n_slots] int64: each slot's item
    iptr: torch.Tensor               # [n_items + 1] int32
    igrp: torch.Tensor               # [n_items] int32
    qptr: torch.Tensor               # [n_groups + 1] int32
    qrows: torch.Tensor              # [sum k] int32
    units: torch.Tensor              # [n_units, 13] int32
    packs: torch.Tensor              # [n_packs, 5] int32
    prows: torch.Tensor              # [sum of staged rows, 2] int32

    def blocks(self, flat: torch.Tensor) -> list:
        """The flat output as one [n_items_g, k_g, k_g] view per group
        (one ``as_strided`` each: half the host time of a slice and a
        view)."""
        out, off = [], flat.storage_offset()
        for g, k in enumerate(self.ks):
            n = self.ibase[g + 1] - self.ibase[g]
            out.append(flat.as_strided((n, k, k), (k * k, k, 1), off))
            off += n * k * k
        return out


def _pad8(n):
    return (n + 7) // 8 * 8


def _pad16(n):
    return (n + 15) // 16 * 16


def _rows(na, nb):
    """Rows a unit stages: chunk a padded to 16, chunk b to 8."""
    return _pad16(na) + _pad8(nb)


def _tiles(na, nb):
    """A unit's 16 x 8 tiles: for nb = 0 (symmetric) those of chunk a's
    16-row tiles I against its 8-row tiles J >= 2 I, else all of chunk a
    against chunk b."""
    ni, ja = _pad16(na) // 16, _pad8(na) // 8
    sym = np.where(ja % 2 == 0, ni * (ni + 1), ni * ni)
    return np.where(np.asarray(nb) == 0, sym, ni * (_pad8(nb) // 8))


def pertrade_work(tiles, slots, rows):
    """A K3 unit's work as the host balances it: its tiles times its
    4-slot steps plus four steps a tile for the epilogue, and for each
    16-slot segment half a step a staged row plus 32."""
    slots = np.maximum(slots, 1)
    return (np.asarray(tiles) * (-(-slots // 4) + 4)
            + -(-slots // PERTRADE_SEG) * (np.asarray(rows) // 2 + 32))


def _chunk_pairs(i: int, k: int, h: int) -> list:
    lo = list(range(0, k, h))
    out = []
    for j, a in enumerate(lo):
        na = min(h, k - a)
        out.append((i, a, na, 0, 0))
        out += [(i, a, na, b, min(h, k - b)) for b in lo[j + 1:]]
    return out


def _pertrade_work(k_of: np.ndarray, counts: np.ndarray):
    """K3's (units [n_units, 5 + 3], packs [n_packs, 4]) for items of
    widths ``k_of`` and slot counts ``counts``. An item is one unit if it
    stages at most PERTRADE_ROWS rows in tiles its warps hold and its
    work is at most the target (the launch's work over PERTRADE_SMS, at
    least PERTRADE_MIN_WORK), else a unit per pair of its row chunks
    (a <= b), the widest chunk (a multiple of 16 from PERTRADE_CHUNK down
    to PERTRADE_CHUNK_MIN) whose units stay within the target. Units are
    ordered by work, largest first, and packed in that order while a pack
    stays within PERTRADE_ROWS staged rows, the target and PERTRADE_WARPS
    warps at PERTRADE_TPW tiles each; a pack's spare warps then go, one at
    a time, to its unit with the most tiles per warp. Columns: (item, a0,
    na, b0, nb, row_off, warp0, n_warps)."""
    live = k_of > 0
    whole = pertrade_work(_tiles(k_of, 0), counts, _rows(k_of, 0))
    target = max(float(whole[live].sum()) / PERTRADE_SMS, PERTRADE_MIN_WORK)
    fits = (_pad16(k_of) <= PERTRADE_ROWS) & (
        _tiles(k_of, 0) <= PERTRADE_TPW * PERTRADE_WARPS)
    one = live & fits & ((whole <= target) | (k_of <= PERTRADE_CHUNK_MIN))
    i1 = np.nonzero(one)[0]
    units = [np.stack([i1, 0 * i1, k_of[i1], 0 * i1, 0 * i1], axis=1)]
    for i in np.nonzero(live & ~one)[0].tolist():
        k = int(k_of[i])
        h = min(PERTRADE_CHUNK, _pad16(k) - 16)
        while h > PERTRADE_CHUNK_MIN and pertrade_work(
                _tiles(h, h), counts[i], _rows(h, h)) > target:
            h -= 16
        units.append(np.asarray(_chunk_pairs(i, k, h)).reshape(-1, 5))
    u = np.concatenate(units).astype(np.int64)
    n_up = _tiles(u[:, 2], u[:, 4])
    slots = counts[u[:, 0]]
    rows = _rows(u[:, 2], u[:, 4])
    work = pertrade_work(n_up, slots, rows)
    o = np.argsort(-work, kind="stable")
    u, n_up, slots, work, rows = u[o], n_up[o], slots[o], work[o], rows[o]
    need = np.maximum(1, -(-n_up // PERTRADE_TPW))
    seg = -(-slots // PERTRADE_SEG)
    table = np.zeros((u.shape[0], 8), dtype=np.int64)
    table[:, :5] = u
    # greedy packing and the spare warps, on plain ints
    rl, nl, wl, ul = (x.tolist() for x in (rows, need, work, n_up))
    warp0, n_warps, packs = [], [], []
    start = 0
    while start < len(rl):
        end, r, wp, wk = start + 1, rl[start], nl[start], wl[start]
        while (end < len(rl) and r + rl[end] <= PERTRADE_ROWS
               and wp + nl[end] <= PERTRADE_WARPS
               and wk + wl[end] <= target):
            r, wp, wk = r + rl[end], wp + nl[end], wk + wl[end]
            end += 1
        nw = nl[start:end]
        for _ in range(PERTRADE_WARPS - sum(nw)):
            per = [-(-t // n) for t, n in zip(ul[start:end], nw)]
            j = per.index(max(per))
            if per[j] <= 1:
                break
            nw[j] += 1
        acc = 0
        for n in nw:
            warp0.append(acc)
            acc += n
        n_warps += nw
        packs.append((start, end, int(seg[start:end].max()), r))
        start = end
    packs = np.asarray(packs, dtype=np.int64).reshape(-1, 4)
    pk = np.repeat(np.arange(len(packs)), packs[:, 1] - packs[:, 0])
    table[:, 5] = np.cumsum(rows) - rows - (np.cumsum(packs[:, 3])
                                            - packs[:, 3])[pk]
    table[:, 6] = warp0
    table[:, 7] = n_warps
    return table, packs


def pertrade_tables(rows: Sequence, n_items: Sequence[int], item, s_idx,
                    e_idx, p_idx, device=None) -> PertradeTables:
    """K3's tables from host arrays: per group its quote rows (``rows``)
    and trade count (``n_items``; the items are numbered group by group),
    and per slot its item and DF columns (s, e, p), in any order. Every
    table is built here in the dtype the kernel takes, so a call checks
    only its own operands."""
    ks = [int(np.asarray(r).shape[0]) for r in rows]
    n_it = np.asarray(n_items, dtype=np.int64)
    ibase = np.concatenate([[0], np.cumsum(n_it)]).astype(np.int64)
    n_items_all = int(ibase[-1])
    item = np.asarray(item, dtype=np.int64)
    order = np.argsort(item, kind="stable")
    counts = np.bincount(item, minlength=n_items_all)
    igrp = np.repeat(np.arange(len(ks)), n_it)
    k_of = np.asarray(ks, dtype=np.int64)[igrp]
    ioff = np.concatenate([[0], np.cumsum(k_of * k_of)])
    if ioff[-1] >= 2 ** 31:
        raise ValueError(f"{ioff[-1]} output values exceed int32 offsets")
    units, packs = _pertrade_work(k_of, counts)
    iptr = np.concatenate([[0], np.cumsum(counts)])
    qptr = np.concatenate([[0], np.cumsum(ks)]).astype(np.int64)
    it = units[:, 0]
    units = np.concatenate([units, np.stack(
        [iptr[it], iptr[it + 1], qptr[igrp[it]], k_of[it], ioff[it]],
        axis=1).reshape(-1, 5)], axis=1)

    qrows = np.concatenate([np.asarray(r) for r in rows]).astype(np.int64) \
        if rows else np.zeros(0, dtype=np.int64)
    # each pack's staged rows, units in order: Jt column (-1 = padding)
    # and unit in the pack
    _, a0, na, b0, nb = units[:, :5].T
    kpa = _pad16(na)
    n_rows = kpa + _pad8(nb)
    ur = np.repeat(np.arange(units.shape[0]), n_rows)
    j = np.arange(ur.shape[0]) - np.repeat(np.cumsum(n_rows) - n_rows, n_rows)
    jb = j - kpa[ur]
    loc = np.where(j < kpa[ur], np.where(j < na[ur], a0[ur] + j, -1),
                   np.where(jb < nb[ur], b0[ur] + jb, -1))
    pk = np.repeat(np.arange(packs.shape[0]), packs[:, 1] - packs[:, 0])
    prows = np.stack([
        np.where(loc >= 0, qrows[units[ur, 10] + np.maximum(loc, 0)], -1),
        ur - packs[pk, 0][ur]], axis=1)
    packs = np.concatenate([packs, (np.cumsum(packs[:, 3])
                                    - packs[:, 3])[:, None]], axis=1)

    def dev(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=dtype),
                               device=device)

    return PertradeTables(
        ks=tuple(ks), ibase=tuple(int(x) for x in ibase),
        n_out=int(ioff[-1]),
        n_cols=int(qrows.max()) + 1 if qrows.size else 0,
        rows_max=int(packs[:, 3].max()) if packs.size else 0,
        order=dev(order, np.int64),
        s_idx=dev(np.asarray(s_idx)[order], np.int32),
        e_idx=dev(np.asarray(e_idx)[order], np.int32),
        p_idx=dev(np.asarray(p_idx)[order], np.int32),
        sitem=dev(item[order], np.int64),
        iptr=dev(iptr, np.int32),
        igrp=dev(igrp, np.int32),
        qptr=dev(qptr, np.int32),
        qrows=dev(qrows, np.int32),
        units=dev(units, np.int32), packs=dev(packs, np.int32),
        prows=dev(prows, np.int32))


def pertrade_quad_form_plain(Jt: torch.Tensor, dfs: torch.Tensor,
                             w: torch.Tensor, tab: PertradeTables) -> list:
    """Plain twin of K3, written from the JAX package's per-slot form
    (``einsum("p,pn,pm->pnm")`` and a scatter-add by trade, chunked):
    Jt [n_grid, N], dfs [n_grid], the slot weights ``w`` in the caller's
    slot order and the tables of :func:`pertrade_tables` -> per group the
    [n_items_g, k_g, k_g] term-1 blocks. A slot's block is the rank-2
    form w (X Yᵀ + Y Xᵀ) over the group's rows, X = (Ja - (a/b) Jb)/b,
    Y = Jc - (c/b) Jb (the JAX package's four products regrouped, as in
    K2's twin)."""
    ws = w[tab.order]
    iptr = tab.iptr.tolist()
    qptr = tab.qptr.tolist()
    out = []
    for g, k in enumerate(tab.ks):
        i0, i1 = tab.ibase[g], tab.ibase[g + 1]
        rows = tab.qrows[qptr[g]:qptr[g + 1]].long()
        blk = torch.zeros((i1 - i0, k, k), dtype=Jt.dtype, device=Jt.device)
        lo, hi = iptr[i0], iptr[i1]
        # bound the [chunk, k, k] per-slot temporary near 200 MB f64
        chunk = max(1, int(2.5e7 // max(k * k, 1)))
        for c0 in range(lo, hi, chunk):
            sl = slice(c0, min(hi, c0 + chunk))
            s, e, p = (x[sl].long() for x in (tab.s_idx, tab.e_idx,
                                              tab.p_idx))
            a, b, c = dfs[s], dfs[e], dfs[p]
            Ja, Jb, Jc = (Jt[x][:, rows] for x in (s, e, p))
            X = (Ja - (a / b)[:, None] * Jb) / b[:, None]
            Y = Jc - (c / b)[:, None] * Jb
            blk.index_add_(0, tab.sitem[sl] - i0,
                           torch.einsum("p,pn,pm->pnm", ws[sl], X, Y))
        out.append(blk + blk.transpose(1, 2))
    return out


def pertrade_quad_form(Jt: torch.Tensor, dfs: torch.Tensor, w: torch.Tensor,
                       tab: PertradeTables) -> list:
    """K3: per group the [n_items_g, k_g, k_g] term-1 blocks (see
    :func:`pertrade_quad_form_plain`): one ``torch.empty`` and one launch
    for every group, the slot weights read through ``order`` by the
    kernel. The tables' dtypes are fixed by :func:`pertrade_tables`; a
    call checks its operands and the tables' device."""
    if not Jt.is_cuda:
        return pertrade_quad_form_plain(Jt, dfs, w, tab)
    dev = Jt.device
    _need(Jt, "Jt", torch.float64, 2, dev)
    _need(dfs, "dfs", torch.float64, 1, dev)
    _need(w, "w", torch.float64, 1, dev)
    n_grid, N = Jt.shape
    if dfs.shape[0] != n_grid:
        raise ValueError(f"dfs {tuple(dfs.shape)} vs Jt {tuple(Jt.shape)}")
    if w.shape[0] != tab.order.shape[0]:
        raise ValueError(f"{w.shape[0]} slot weights, the tables "
                         f"{tab.order.shape[0]} slots")
    if tab.n_cols > N:
        raise ValueError(f"the tables need {tab.n_cols} Jt columns, Jt "
                         f"has {N}")
    if tab.packs.device != dev:
        raise ValueError(f"the tables are on {tab.packs.device}, expected "
                         f"{dev}")
    out = torch.empty(tab.n_out, dtype=torch.float64, device=dev)
    n_packs = tab.packs.shape[0]
    if n_packs:
        if _lib is None:
            build_kernels()
        _check(_lib.pertrade_quad_f64(
            Jt.data_ptr(), N, dfs.data_ptr(), w.data_ptr(),
            tab.order.data_ptr(), tab.packs.data_ptr(), n_packs,
            tab.rows_max, tab.units.data_ptr(), tab.prows.data_ptr(),
            tab.s_idx.data_ptr(), tab.e_idx.data_ptr(), tab.p_idx.data_ptr(),
            out.data_ptr(), _stream(dev)),
            "pertrade_quad_f64")
        pertrade_quad_form.launches += 1
    return tab.blocks(out)


pertrade_quad_form.launches = 0


# ---------------------------------------------------------------------------
# K4 / K5: the OIS pv01 chain solve and its transpose
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ChainTables:
    """K4's and K5's tables: an OIS point plan's previous-point links,
    every one strictly backward (checked by :func:`chain_tables`), and
    the JAX package's child table, which the plain transpose sweep
    gathers through. ``shape`` is the plan's own, (P,) or (G, P) for a
    stacked plan; a tensor the solve reads ends in it."""
    shape: tuple
    depth: int
    prev: torch.Tensor        # [G, P] int32, -1 at a root
    has_prev: torch.Tensor    # [*shape] bool
    prev_flat: torch.Tensor   # [G * P] int64: g * P + max(prev, 0)
    child_flat: torch.Tensor  # [G * P * Kc] int64: g * P + child
    child_mask: torch.Tensor  # [*shape, Kc] f64


def chain_tables(prev_idx, child_idx, child_mask, depth: int,
                 device) -> ChainTables:
    """K4/K5's tables on ``device`` from a (stacked) OIS plan's host
    arrays: ``prev_idx`` [P] or [G, P], ``child_idx`` / ``child_mask``
    [..., P, Kc]. Raises ValueError unless every point's previous point
    precedes it, which the kernels' single pass relies on."""
    prev = np.asarray(prev_idx, dtype=np.int64)
    shape = prev.shape
    P = shape[-1]
    rows = prev.reshape(-1, P)
    G = rows.shape[0]
    if np.any(rows >= np.arange(P)):
        raise ValueError("OIS plan: a point's previous point does not "
                         "precede it")
    off = (np.arange(G) * P)[:, None]
    child = np.asarray(child_idx, dtype=np.int64).reshape(G, P, -1)
    return ChainTables(
        shape=tuple(shape), depth=int(depth),
        prev=torch.as_tensor(rows.astype(np.int32), device=device),
        has_prev=torch.as_tensor(prev >= 0, device=device),
        prev_flat=torch.as_tensor((off + np.maximum(rows, 0)).reshape(-1),
                                  device=device),
        child_flat=torch.as_tensor((off[:, :, None] + child).reshape(-1),
                                   device=device),
        child_mask=torch.as_tensor(np.asarray(child_mask,
                                              dtype=np.float64),
                                   device=device))


def chain_matvec(x: torch.Tensor, denom: torch.Tensor,
                 tab: ChainTables) -> torch.Tensor:
    """A x, (A x)_i = x[prev_i] / d_i (0 at a root), over tensors
    [..., *tab.shape]."""
    flat = x.reshape(x.shape[:x.dim() - len(tab.shape)] + (-1,))
    g = flat.index_select(-1, tab.prev_flat).reshape(x.shape)
    return torch.where(tab.has_prev, g, 0.0) / denom


def chain_matvec_t(y: torch.Tensor, denom: torch.Tensor,
                   tab: ChainTables) -> torch.Tensor:
    """A' y, (A' y)_j = the sum of y_i / d_i over the points i whose
    previous point is j: the JAX package's child-table gather
    (``adrates_tpu/ops/bootstrap.py:313-318``)."""
    yd = y / denom
    yd = yd.reshape(yd.shape[:yd.dim() - len(tab.shape)] + (-1,))
    yd = yd.index_select(-1, tab.child_flat)
    return (tab.child_mask * yd.reshape(y.shape + (-1,))).sum(-1)


def pv01_solve_plain(b: torch.Tensor, denom: torch.Tensor,
                     tab: ChainTables) -> torch.Tensor:
    """Plain version of K4: (I - A)^-1 b by ``depth`` Horner sweeps
    x <- b + A x, the K-sweep of the JAX package's ``solve``. ``b`` and
    ``denom`` are [R, P]; row r runs on plan row r mod G."""
    bb = b.reshape((-1,) + tab.shape)
    dd = denom.reshape((-1,) + tab.shape)
    x = bb
    for _ in range(max(tab.depth, 1)):
        x = bb + chain_matvec(x, dd, tab)
    return x.reshape(b.shape)


def pv01_solve_t_plain(c: torch.Tensor, denom: torch.Tensor,
                       tab: ChainTables) -> torch.Tensor:
    """Plain version of K5: (I - A)^-T c by ``depth`` sweeps
    y <- c + A' y over the child table, the JAX package's
    ``transpose_solve``; the layout of :func:`pv01_solve_plain`."""
    cc = c.reshape((-1,) + tab.shape)
    dd = denom.reshape((-1,) + tab.shape)
    y = cc
    for _ in range(max(tab.depth, 1)):
        y = cc + chain_matvec_t(y, dd, tab)
    return y.reshape(c.shape)


def _chain_rows(rhs: torch.Tensor, denom: torch.Tensor, tab: ChainTables):
    G, P = tab.prev.shape
    if rhs.dim() != 2 or rhs.shape != denom.shape or rhs.shape[1] != P \
            or rhs.shape[0] % G:
        raise ValueError(f"the solve takes [R, {P}] rows with R a "
                         f"multiple of {G}; got {tuple(rhs.shape)} and "
                         f"{tuple(denom.shape)}")


def _chain_launch(entry: str, rhs: torch.Tensor, denom: torch.Tensor,
                  tab: ChainTables) -> torch.Tensor:
    dev = rhs.device
    _need(rhs, "rhs", torch.float64, 2, dev)
    _need(denom, "denom", torch.float64, 2, dev)
    _need(tab.prev, "prev", torch.int32, 2, dev)
    R, P = rhs.shape
    out = torch.empty_like(rhs)
    if R == 0 or P == 0:
        return out
    if _lib is None:
        build_kernels()
    _check(getattr(_lib, entry)(rhs.data_ptr(), denom.data_ptr(),
                                tab.prev.data_ptr(), R, P,
                                tab.prev.shape[0], out.data_ptr(),
                                _stream(dev)), entry)
    return out


def pv01_solve(b: torch.Tensor, denom: torch.Tensor,
               tab: ChainTables) -> torch.Tensor:
    """K4: x = (I - A)^-1 b over [R, P] rows (see
    :func:`pv01_solve_plain`), one pass in ascending point order, one
    ``torch.empty`` and one launch. ``calls`` counts calls on either
    path, ``launches`` the kernel's launches."""
    _chain_rows(b, denom, tab)
    pv01_solve.calls += 1
    if not b.is_cuda:
        return pv01_solve_plain(b, denom, tab)
    out = _chain_launch("pv01_solve_f64", b, denom, tab)
    pv01_solve.launches += 1
    return out


pv01_solve.launches = 0
pv01_solve.calls = 0


def pv01_solve_t(c: torch.Tensor, denom: torch.Tensor,
                 tab: ChainTables) -> torch.Tensor:
    """K5: y = (I - A)^-T c over [R, P] rows (see
    :func:`pv01_solve_t_plain`), one pass in descending point order; the
    counters of :func:`pv01_solve`."""
    _chain_rows(c, denom, tab)
    pv01_solve_t.calls += 1
    if not c.is_cuda:
        return pv01_solve_t_plain(c, denom, tab)
    out = _chain_launch("pv01_solve_t_f64", c, denom, tab)
    pv01_solve_t.launches += 1
    return out


pv01_solve_t.launches = 0
pv01_solve_t.calls = 0


# ---------------------------------------------------------------------------
# K6 / K7: the fitted schemes' rows at static queries, and their transpose
# ---------------------------------------------------------------------------

# member kinds (csrc/fitted_rows.cu): a Hermite cubic on given slopes (the
# PCHIP schemes), a natural spline, a spline natural on the left and
# clamped (S' = 0) on the right
FIT_HERMITE, FIT_NATURAL, FIT_CLAMPED = 0, 1, 2
# a K6 block stages two f64 rows of n_max | 1 values a tile row in at most
# 96 KB of shared memory (csrc/fitted_rows.cu kSmemBudget), so a tile of
# K6's smallest tile (one row and, in tangent mode, one direction: the
# knot values, slopes and a spline's two coefficient rows of both, and the
# spline solve's scratch row, nine rows of n | 1 doubles) takes members of
# up to FIT_MAX_KNOTS knots in a block's most shared memory (227 KB)
FIT_MAX_KNOTS = 227 * 1024 // 72 - 1
# K7 streams a member's queries, in interval order, in chunks of at most
# FIT_CHUNK queries and FIT_SEGS segments (csrc/fitted_rows.cu kChunk,
# kSegs), a segment being at most FIT_SEG_LEN queries of one interval; a
# chunk reaches at most 2 FIT_SEGS knots, and its tables take FIT_TAB
# ints (kTab: its segments, then its knots as pairs)
FIT_CHUNK = 256
FIT_SEGS = 32
FIT_SEG_LEN = 8
FIT_TAB = 5 * FIT_SEGS


@dataclasses.dataclass(frozen=True, eq=False)
class FittedTables:
    """K6's and K7's tables for G members, each a cubic Hermite map on its
    own knots x_g (n_g of them) to its own static queries q_g (W_g of
    them, flattened), all on one device and padded to ``n_max`` knots and
    ``W_max`` queries.

    The map K6 computes is linear: from y [R, G, n_max] (a member's knot
    values) and, for a Hermite member, its slopes d to u [R, G, W_max],
    the cubic Hermite interpolant at each query,

        u = w00 y_i + w10 d_i + w01 y_{i+1} + w11 d_{i+1},  i = idx(q),

    with the static weights ``qw`` = (h00, h10 h, h01, h11 h) of
    ``hermite_eval``. A spline member's slopes are d = T^-1 R y: T its
    knot-slope tridiagonal (``cubic_spline_coeffs``), factored once here
    in f64 (``sp``: Thomas multipliers l, reciprocal pivots 1 / b', the
    super-diagonal c; K7's T^-T), and R the static tridiagonal map from y
    to the right-hand side (``sp``: rl, rd, ru). K6 takes a spline's slopes
    and rows as the plain version does, operation for operation: the
    right-hand side from the secants, the parallel cyclic reduction of
    ``utils/math.solve_tridiagonal`` on T's coefficients reduced here in
    its order (``pc``: the interval lengths h, the reduced diagonal b and
    each of the st = ceil(log2 n_max) steps' alpha and gamma), and
    ``cubic_eval``'s power form on the offsets ``qu`` = q - x[idx]. A
    cubic's extrapolation far past the last knot multiplies any rounding
    difference by up to (q - x)^3 / h^3, so the two agree only in one
    order of operations. The input of K6 is
    X [R, G, K, n_max]: y in slot 0 and, where ``K`` is 2 (some member
    is Hermite), the given slopes in slot 1. Pad knots are decoupled:
    T's pad rows are identity rows, R's and the weights' pad entries 0,
    pad intervals 1 long, and no query brackets a pad; pad queries
    evaluate to 0. K7 takes u-bar [R, G, W_max] to X-bar through ``iq``
    / ``ikey`` (each member's queries by interval, in query order within
    an interval, and each one's interval) cut into chunks, segments and
    knots (:func:`_fit_stream`): ``fcp`` [G + 1] the members' ranges of
    ``fchunk`` [chunks + G, 4] (each member's chunks and an end entry:
    the chunk's first position in ``iq``, its counts of segments and
    knots, and 1 + its first query where its queries are consecutive in
    memory, else 0) and ``ftab`` [chunks + G, FIT_TAB] (the same rows:
    the chunk's segments, a segment's first position in the chunk | its
    length << 16, from column 0; its knots as pairs from column
    FIT_SEGS, a knot the chunk's segments reach: the knot | the first
    << 16 and the end << 24 of the chunk's segments in the interval right
    of it, whose left sums it takes; the first | the end << 8 of those in
    the interval left of it, whose right sums it takes). ``nc`` is the
    most rows of ``fchunk`` a member has.

    ``host`` keeps the padded knots and queries in numpy (``x``, ``q``,
    ``idx``, ``qmask``, ``ns``, ``kinds``, T's ``bands``); the plain
    twins build their own tensors from it on first use (:attr:`twin`)."""
    G: int
    n_max: int
    W_max: int
    K: int
    kind: torch.Tensor        # [G] int32
    nk: torch.Tensor          # [G] int32 knots
    nw: torch.Tensor          # [G] int32 queries
    qidx: torch.Tensor        # [G, W_max] int32 bracket
    qw: torch.Tensor          # [G, W_max, 4] f64 Hermite weights
    sp: torch.Tensor          # [G, 6, n_max] f64: l, 1/b', c, rl, rd, ru
    pc: torch.Tensor          # [G, 2 + 2 st, n_max] f64: h, b, alpha, gamma
    qu: torch.Tensor          # [G, W_max] f64: q - x[idx]
    iq: torch.Tensor          # [G, W_max] int32 queries by interval
    ikey: torch.Tensor        # [G, W_max] int32 the interval of iq's query
    fcp: torch.Tensor         # [G + 1] int32 members' chunk ranges
    fchunk: torch.Tensor      # [chunks + G, 4] int32 K7's chunks
    ftab: torch.Tensor        # [chunks + G, FIT_TAB] int32 their tables
    nc: int                   # the most chunks of a member, + 1
    host: dict

    @functools.cached_property
    def twin(self) -> "_FitTwin":
        """The plain twins' tensors, on the tables' device."""
        return _fit_twin(self.host, self.qw.device)


@dataclasses.dataclass(frozen=True, eq=False)
class _FitTwin:
    """What ``fitted_rows_plain`` / ``fitted_rows_t_plain`` read beside
    :class:`FittedTables` to repeat ``cubic_spline_coeffs`` /
    ``cubic_eval`` and ``hermite_eval`` operation for operation."""
    spline: torch.Tensor      # [G, 1] bool: a spline member
    any_spline: bool
    any_hermite: bool
    qmask: torch.Tensor       # [G, W_max] bool real queries
    idx: torch.Tensor         # [G, W_max] int64 bracket
    uq: torch.Tensor          # [G, W_max] q - x[idx]
    h: torch.Tensor           # [G, n_max - 1] interval lengths (pads 1)
    ih: torch.Tensor          # [G, n_max, 2] inv_h left and right of a knot
    hh: torch.Tensor          # [G, n_max - 1] h * h
    first: torch.Tensor       # [G, n_max] bool knot 0
    last: torch.Tensor        # [G, n_max] bool the last knot
    rhs0: torch.Tensor        # [G, n_max] bool rhs rows set to 0
    bands: torch.Tensor       # [G, 3, n_max] T's lower, diag, upper
    bands_t: torch.Tensor     # [G, 3, n_max] T^T's lower, diag, upper


def _fit_twin(host: dict, device) -> _FitTwin:
    x, q, idx, qmask = host["x"], host["q"], host["idx"], host["qmask"]
    ns, kinds, bands = host["ns"], host["kinds"], host["bands"]
    G, n_max = x.shape
    h = x[:, 1:] - x[:, :-1]
    inv_h = 1.0 / h
    ih = np.zeros((G, n_max, 2))
    ih[:, 1:, 0] = inv_h
    ih[:, :-1, 1] = inv_h
    knot = np.arange(n_max)[None, :]
    pad = knot >= np.asarray(ns)[:, None]
    last = knot == np.asarray(ns)[:, None] - 1
    spl = np.array([k != FIT_HERMITE for k in kinds])
    clamped = np.array([k == FIT_CLAMPED for k in kinds])
    rhs0 = pad | ~spl[:, None] | (last & clamped[:, None])
    bands_t = np.zeros_like(bands)
    bands_t[:, 1] = bands[:, 1]
    bands_t[:, 0, 1:] = bands[:, 2, :-1]
    bands_t[:, 2, :-1] = bands[:, 0, 1:]

    def t(a, dtype=np.float64):
        return torch.as_tensor(np.ascontiguousarray(a, dtype), device=device)

    return _FitTwin(
        spline=t(spl[:, None], bool), any_spline=bool(spl.any()),
        any_hermite=bool((~spl).any()), qmask=t(qmask, bool),
        idx=t(idx, np.int64), uq=t(q - np.take_along_axis(x, idx, 1)),
        h=t(h), ih=t(ih), hh=t(h * h), first=t(knot == 0, bool),
        last=t(last, bool), rhs0=t(rhs0, bool), bands=t(bands),
        bands_t=t(bands_t))


def _spline_rows(x: np.ndarray, clamped: bool):
    """One spline member's T bands (``cubic_spline_coeffs``' formulas, in
    its order of operations), Thomas factors and R, on its n real
    knots."""
    n = x.shape[0]
    h = x[1:] - x[:-1]
    inv_h = 1.0 / h
    lower = np.concatenate([[0.0], inv_h[:-1], [1.0]])
    diag = np.concatenate([[2.0], 2.0 * (inv_h[:-1] + inv_h[1:]), [2.0]])
    upper = np.concatenate([[1.0], inv_h[1:], [0.0]])
    rl, rd, ru = np.zeros(n), np.zeros(n), np.zeros(n)
    rd[0], ru[0] = -3.0 / h[0], 3.0 / h[0]
    a = 3.0 * inv_h / h                      # 3 / h^2 by interval
    rl[1:n - 1] = -a[:-1]
    rd[1:n - 1] = a[:-1] - a[1:]
    ru[1:n - 1] = a[1:]
    if clamped:
        lower[n - 1], diag[n - 1] = 0.0, 1.0
    else:
        rl[n - 1], rd[n - 1] = -3.0 / h[-1], 3.0 / h[-1]
    piv = diag.copy()
    l = np.zeros(n)
    for i in range(1, n):
        l[i] = lower[i] / piv[i - 1]
        piv[i] = diag[i] - l[i] * upper[i - 1]
    return (lower, diag, upper), (l, 1.0 / piv, upper.copy(), rl, rd, ru)


def pcr_steps(n: int) -> int:
    """The steps of ``utils/math.solve_tridiagonal``'s parallel cyclic
    reduction of n rows (csrc/fitted_rows.cu pcr_steps)."""
    return max(1, math.ceil(math.log2(n))) if n > 1 else 0


def _pcr_table(x: np.ndarray, bands: np.ndarray) -> np.ndarray:
    """K6's table of the spline solve, [G, 2 + 2 st, n_max]: the interval
    lengths h (of the padded knots ``x``), then T's coefficients (``bands``
    [G, 3, n_max]) reduced by ``utils/math.solve_tridiagonal``'s steps in
    its order of operations: the final diagonal b, then each step's alpha
    and gamma. They depend on the knots alone, so the plain version's
    right-hand side goes through exactly these coefficients."""
    G, n = x.shape
    st = pcr_steps(n)
    out = np.zeros((G, 2 + 2 * st, n))
    out[:, 0, :-1] = x[:, 1:] - x[:, :-1]
    out[:, 0, -1] = 1.0
    a = np.concatenate([np.zeros((G, 1)), bands[:, 0, 1:]], axis=-1)
    b = bands[:, 1].copy()
    c = np.concatenate([bands[:, 2, :n - 1], np.zeros((G, 1))], axis=-1)

    def up(v, s, fill):
        return np.concatenate([np.full((G, s), fill), v[:, :-s]], axis=-1)

    def dn(v, s, fill):
        return np.concatenate([v[:, s:], np.full((G, s), fill)], axis=-1)

    s = 1
    for k in range(st):
        alpha = -a / up(b, s, 1.0)
        gamma = -c / dn(b, s, 1.0)
        out[:, 2 + 2 * k] = alpha
        out[:, 3 + 2 * k] = gamma
        a, b, c = (alpha * up(a, s, 0.0),
                   b + alpha * up(c, s, 0.0) + gamma * dn(a, s, 0.0),
                   gamma * dn(c, s, 0.0))
        s *= 2
    out[:, 1] = b
    return out


def _fit_stream(key: np.ndarray, iq: np.ndarray):
    """K7's cut of one member's queries in interval order (``iq``, their
    intervals ``key``, nondecreasing): chunks of at most ``FIT_CHUNK``
    queries and ``FIT_SEGS`` segments; a segment, at most
    ``FIT_SEG_LEN`` consecutive queries of one interval within a chunk
    (a chunk's segments of one interval are consecutive); the knots that
    a chunk's segments reach, each with its two ranges of segments, those
    of the interval right of it and those of the one left of it. Returns
    the chunks [c + 1, 4] (first position, segments, knots, and 1 + its
    first query where its queries are consecutive in memory, else 0; the
    last entry the end) and their tables [c + 1, FIT_TAB] (see
    :class:`FittedTables`)."""
    W = key.size
    chunks, tabs = [], []
    k = 0
    while k < W:
        k0, segs = k, []
        runs = {}                           # interval: its segments
        while k < W and k - k0 < FIT_CHUNK and len(segs) < FIT_SEGS:
            end = min(k + FIT_SEG_LEN, k0 + FIT_CHUNK, W)
            e = k + int(np.searchsorted(key[k:end], key[k], side="right"))
            j = int(key[k])
            runs[j] = (runs.get(j, (len(segs), 0))[0], len(segs) + 1)
            segs.append((k - k0) | (e - k) << 16)
            k = e
        knots = []
        for i in sorted(set(runs) | {j + 1 for j in runs}):
            lb, le = runs.get(i, (0, 0))
            rb, re = runs.get(i - 1, (0, 0))
            knots += [i | lb << 16 | le << 24, rb | re << 8]
        tab = np.zeros(FIT_TAB, np.int64)
        tab[:len(segs)] = segs
        tab[FIT_SEGS:FIT_SEGS + len(knots)] = knots
        cons = bool(np.all(np.diff(iq[k0:k]) == 1))
        chunks.append((k0, len(segs), len(knots) // 2,
                       1 + int(iq[k0]) if cons else 0))
        tabs.append(tab)
    chunks.append((W, 0, 0, 0))
    tabs.append(np.zeros(FIT_TAB, np.int64))
    return np.array(chunks, np.int64), np.stack(tabs)


def fitted_tables(members: Sequence[tuple], device) -> FittedTables:
    """K6/K7's tables on ``device`` for ``members``, each (x, q, idx,
    kind): its knots, its static queries (any shape), their brackets
    (``ops/interpolation.fitted_index``) and its kind (``FIT_HERMITE``,
    ``FIT_NATURAL``, ``FIT_CLAMPED``). Raises ValueError on a member of
    fewer than 2 or more than ``FIT_MAX_KNOTS`` knots, or a bracket
    outside its grid."""
    G = len(members)
    if G == 0:
        raise ValueError("fitted_tables: no member")
    xs = [np.asarray(m[0], np.float64) for m in members]
    qs = [np.asarray(m[1], np.float64).reshape(-1) for m in members]
    ids = [np.asarray(m[2], np.int64).reshape(-1) for m in members]
    kinds = [int(m[3]) for m in members]
    ns = [x.shape[0] for x in xs]
    if min(ns) < 2 or max(ns) > FIT_MAX_KNOTS:
        raise ValueError(f"fitted_tables: knot counts {ns} outside [2, "
                         f"{FIT_MAX_KNOTS}]")
    ws = [q.size for q in qs]
    n_max, W_max = max(ns), max(ws)

    x = np.zeros((G, n_max))
    q = np.zeros((G, W_max))
    idx = np.zeros((G, W_max), np.int64)
    qmask = np.zeros((G, W_max), bool)
    for g in range(G):
        n, w = ns[g], ws[g]
        x[g, :n] = xs[g]
        x[g, n:] = xs[g][-1] + 1.0 + np.arange(n_max - n)
        q[g, :w] = qs[g]
        q[g, w:] = xs[g][0]
        idx[g, :w] = ids[g]
        qmask[g, :w] = True
    if np.any(idx < 0) or np.any(idx > np.asarray(ns)[:, None] - 2):
        raise ValueError("fitted_tables: a bracket outside its grid")
    # hermite_eval's weights, in its order of operations
    x0 = np.take_along_axis(x, idx, 1)
    hq = np.take_along_axis(x, idx + 1, 1) - x0
    s = (q - x0) / hq
    s2 = s * s
    s3 = s2 * s
    qw = np.stack([2.0 * s3 - 3.0 * s2 + 1.0, (s3 - 2.0 * s2 + s) * hq,
                   -2.0 * s3 + 3.0 * s2, (s3 - s2) * hq], axis=-1)
    qw[~qmask] = 0.0

    sp = np.zeros((G, 6, n_max))
    sp[:, 1] = 1.0
    bands = np.zeros((G, 3, n_max))
    bands[:, 1] = 1.0
    for g in range(G):
        if kinds[g] != FIT_HERMITE:
            n = ns[g]
            bnd, fac = _spline_rows(xs[g], kinds[g] == FIT_CLAMPED)
            bands[g, :, :n] = np.stack(bnd)
            sp[g, :, :n] = np.stack(fac)
    qu = q - np.take_along_axis(x, idx, 1)
    qu[~qmask] = 0.0

    iq = np.zeros((G, W_max), np.int32)
    ikey = np.zeros((G, W_max), np.int32)
    fcp, fchunk, ftab = [0], [], []
    for g in range(G):
        w = ws[g]
        order = np.argsort(ids[g], kind="stable")
        iq[g, :w] = order
        ikey[g, :w] = ids[g][order]
        ch, tb = _fit_stream(ikey[g, :w], iq[g, :w])
        fchunk.append(ch)
        ftab.append(tb)
        fcp.append(fcp[-1] + ch.shape[0])

    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a, dtype), device=device)

    return FittedTables(
        G=G, n_max=n_max, W_max=W_max,
        K=2 if FIT_HERMITE in kinds else 1, kind=t(kinds, np.int32),
        nk=t(ns, np.int32), nw=t(ws, np.int32), qidx=t(idx, np.int32),
        qw=t(qw, np.float64), sp=t(sp, np.float64),
        pc=t(_pcr_table(x, bands), np.float64), qu=t(qu, np.float64),
        iq=t(iq, np.int32),
        ikey=t(ikey, np.int32), fcp=t(fcp, np.int32),
        fchunk=t(np.concatenate(fchunk), np.int32),
        ftab=t(np.concatenate(ftab), np.int32),
        nc=int(np.diff(fcp).max()),
        host=dict(x=x, q=q, idx=idx, qmask=qmask, ns=ns, kinds=kinds,
                  bands=bands))


def _fit_gather(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """v [R, G, n] at the static per-member indices idx [G, W]."""
    return v.gather(-1, idx.expand(v.shape[:-1] + idx.shape[-1:]))


def fitted_rows_plain(X: torch.Tensor, tab: FittedTables) -> torch.Tensor:
    """Plain version of K6: U [R, G, W_max] from X [R, G, K, n_max]. A
    Hermite member runs ``hermite_eval``'s arithmetic on the given
    slopes; a spline member ``cubic_spline_coeffs`` (the PCR solve and the
    scipy-layout coefficients) and ``cubic_eval``, stacked: the pad rows
    are decoupled identity rows, so each member's values are bit for bit
    those of its own fit. Pad queries are 0."""
    from ..utils.math import solve_tridiagonal
    tw = tab.twin
    y = X[:, :, 0]
    val = None
    if tw.any_hermite:
        d = X[:, :, 1]
        w = tab.qw
        y0 = _fit_gather(y, tw.idx)
        y1 = _fit_gather(y, tw.idx + 1)
        d0 = _fit_gather(d, tw.idx)
        d1 = _fit_gather(d, tw.idx + 1)
        val = w[..., 0] * y0 + w[..., 1] * d0 + w[..., 2] * y1 \
            + w[..., 3] * d1
    if tw.any_spline:
        h = tw.h
        m = (y[..., 1:] - y[..., :-1]) / h
        m_prev = torch.cat([m[..., :1], m], dim=-1)
        m_next = torch.cat([m, m[..., -1:]], dim=-1)
        interior = 3.0 * (m_prev * tw.ih[..., 0] + m_next * tw.ih[..., 1])
        rhs = torch.where(tw.first, 3.0 * m_next,
                          torch.where(tw.last, 3.0 * m_prev, interior))
        rhs = torch.where(tw.rhs0, 0.0, rhs)
        s = solve_tridiagonal(tw.bands[:, 0], tw.bands[:, 1],
                              tw.bands[:, 2], rhs)
        s0 = s[..., :-1]
        s1 = s[..., 1:]
        c1 = (3.0 * m - 2.0 * s0 - s1) / h
        c0 = (s0 + s1 - 2.0 * m) / tw.hh
        u = tw.uq
        spl = ((_fit_gather(c0, tw.idx) * u + _fit_gather(c1, tw.idx)) * u
               + _fit_gather(s0, tw.idx)) * u + _fit_gather(y, tw.idx)
        val = spl if val is None else torch.where(tw.spline, spl, val)
    return torch.where(tw.qmask, val, 0.0)


def fitted_rows_t_plain(Ub: torch.Tensor, tab: FittedTables) -> torch.Tensor:
    """Plain version of K7, the transpose of K6: X-bar [R, G, K, n_max]
    from U-bar [R, G, W_max]. The query cotangents scattered onto their
    brackets' Hermite inputs; for a spline member the slope cotangents
    through T^-T (the PCR solve on T's transpose) and R^T into the knot
    values' and its slope slot 0; pads 0."""
    from ..utils.math import solve_tridiagonal
    tw = tab.twin
    R = Ub.shape[0]
    ub = torch.where(tw.qmask, Ub, 0.0)
    w = tab.qw
    shape = (R, tab.G, tab.n_max)
    i0 = tw.idx.expand(ub.shape)
    i1 = (tw.idx + 1).expand(ub.shape)
    yb = Ub.new_zeros(shape).scatter_add(-1, i0, w[..., 0] * ub) \
        .scatter_add(-1, i1, w[..., 2] * ub)
    sb = Ub.new_zeros(shape).scatter_add(-1, i0, w[..., 1] * ub) \
        .scatter_add(-1, i1, w[..., 3] * ub)
    if tw.any_spline:
        z = solve_tridiagonal(tw.bands_t[:, 0], tw.bands_t[:, 1],
                              tw.bands_t[:, 2],
                              torch.where(tw.spline, sb, 0.0))
        sp = tab.sp
        zero = z.new_zeros(z.shape[:-1] + (1,))
        rtz = sp[:, 4] * z \
            + torch.cat([sp[:, 3, 1:] * z[..., 1:], zero], dim=-1) \
            + torch.cat([zero, sp[:, 5, :-1] * z[..., :-1]], dim=-1)
        yb = yb + torch.where(tw.spline, rtz, 0.0)
    if tab.K == 1:
        return yb.unsqueeze(2)
    return torch.stack([yb, torch.where(tw.spline, 0.0, sb)], dim=2)


def _fit_shapes(t: torch.Tensor, tab: FittedTables, what: str, tail):
    if t.dim() != 2 + len(tail) or t.shape[1] != tab.G \
            or tuple(t.shape[2:]) != tail:
        raise ValueError(f"{what} takes [R, {tab.G}, "
                         f"{', '.join(map(str, tail))}]; got "
                         f"{tuple(t.shape)}")


def _fit_launch(entry: str, inp: torch.Tensor, out_shape,
                tab: FittedTables, *extra) -> torch.Tensor:
    dev = inp.device
    _need(inp, "input", torch.float64, inp.dim(), dev)
    _need(tab.qw, "qw", torch.float64, 3, dev)
    out = torch.empty(out_shape, dtype=torch.float64, device=dev)
    R = inp.shape[0]
    if out.numel() == 0 or R == 0:
        return out
    if _lib is None:
        build_kernels()
    _check(getattr(_lib, entry)(
        inp.data_ptr(), R, tab.G, tab.K, tab.n_max, tab.W_max,
        tab.kind.data_ptr(), tab.nk.data_ptr(), tab.nw.data_ptr(), *extra,
        out.data_ptr(), _stream(dev)), entry)
    return out


def fitted_rows(X: torch.Tensor, tab: FittedTables) -> torch.Tensor:
    """K6: U [R, G, W_max] from X [R, G, K, n_max] (see
    :class:`FittedTables` and :func:`fitted_rows_plain`): one block a
    (tile of rows, member), a spline member's slopes solved a warp a row
    in the plain version's order (``pc``), then a thread a query over the
    tile's rows from shared memory; one ``torch.empty`` and one launch."""
    _fit_shapes(X, tab, "fitted_rows", (tab.K, tab.n_max))
    if not X.is_cuda:
        return fitted_rows_plain(X, tab)
    out = _fit_launch("fitted_rows_f64", X, (X.shape[0], tab.G, tab.W_max),
                      tab, tab.qidx.data_ptr(), tab.qw.data_ptr(),
                      tab.qu.data_ptr(), tab.pc.data_ptr())
    fitted_rows.launches += 1
    return out


fitted_rows.launches = 0


def fitted_rows_t(Ub: torch.Tensor, tab: FittedTables) -> torch.Tensor:
    """K7: X-bar [R, G, K, n_max] from U-bar [R, G, W_max], the exact
    transpose of :func:`fitted_rows` (see :func:`fitted_rows_t_plain`):
    a block a (tile of rows, member) streams the member's cotangents in
    interval order through shared memory, a chunk at a time, sums each
    static segment's weighted cotangents (a thread a segment and row),
    then each knot's segments into it (a thread a knot and row: a fixed
    order, no atomics), a spline member's slope cotangents through T^-T
    by the same factors and R^T; one ``torch.empty`` and one launch."""
    _fit_shapes(Ub, tab, "fitted_rows_t", (tab.W_max,))
    if not Ub.is_cuda:
        return fitted_rows_t_plain(Ub, tab)
    out = _fit_launch("fitted_rows_t_f64", Ub,
                      (Ub.shape[0], tab.G, tab.K, tab.n_max), tab,
                      tab.qw.data_ptr(), tab.sp.data_ptr(),
                      tab.iq.data_ptr(), tab.fcp.data_ptr(),
                      tab.fchunk.data_ptr(), tab.ftab.data_ptr(), tab.nc)
    fitted_rows_t.launches += 1
    return out


fitted_rows_t.launches = 0


def _fit_dfs(t: torch.Tensor, tab: FittedTables, what: str, lead: int):
    if t.dim() != lead + 2 or t.shape[lead] != tab.G \
            or t.shape[lead + 1] < tab.n_max:
        rows = "R, D" if lead == 2 else "R"
        raise ValueError(f"{what} takes DFs [{rows}, {tab.G}, L >= "
                         f"{tab.n_max}]; got {tuple(t.shape)}")


def _eval_tables(plan, dev) -> tuple:
    """K6's table pointers after the output (kind .. fac) of ``plan``
    (an ``ops/fitted_rows.FittedPlan``), checked on ``dev``."""
    tab = plan.tables
    for name, t, dtype, nd in (("fx", plan.fx, torch.float64, 3),
                               ("fac", plan.fac, torch.float64, 2),
                               ("fmode", plan.fmode, torch.int32, 1),
                               ("qu", tab.qu, torch.float64, 2),
                               ("pc", tab.pc, torch.float64, 3)):
        _need(t, name, dtype, nd, dev)
    return tuple(t.data_ptr() for t in (
        tab.kind, tab.nk, tab.nw, plan.fmode, tab.qidx, tab.qw, tab.qu,
        tab.pc, plan.fx, plan.fac))


def fitted_eval(dfs: torch.Tensor, plan) -> torch.Tensor:
    """K6: the members' DFs at their queries [R, G, W_max] from the DFs
    ``dfs`` [R, G, L] (member g's knots first; pads and positions past
    them not read), for ``plan`` an ``ops/fitted_rows.FittedPlan`` (see
    ``fitted_rows.fitted_eval_plain``): one block a (tile of rows,
    member, tile of queries where one-row tiles leave SMs idle), the
    tables staged in shared memory, the transforms a thread a (row, knot),
    a spline member's solve a warp a row, then a thread a query writes
    exp(fac u) in every row of the tile, each in the plain version's
    order of operations; one ``torch.empty`` and one launch."""
    tab = plan.tables
    _fit_dfs(dfs, tab, "fitted_eval", 1)
    if not dfs.is_cuda:
        from .fitted_rows import fitted_eval_plain
        return fitted_eval_plain(plan, dfs, fitted_rows)
    dev = dfs.device
    _need(dfs, "dfs", torch.float64, 3, dev)
    R, _, L = dfs.shape
    out = torch.empty((R, tab.G, tab.W_max), dtype=torch.float64,
                      device=dev)
    if out.numel() == 0:
        return out
    if _lib is None:
        build_kernels()
    _check(_lib.fitted_eval_f64(
        dfs.data_ptr(), R, tab.G, L, tab.n_max, tab.W_max,
        *_eval_tables(plan, dev), out.data_ptr(), _stream(dev)),
        "fitted_eval_f64")
    fitted_eval.launches += 1
    return out


fitted_eval.launches = 0


def fitted_eval_jvp(dfs: torch.Tensor, ddfs: torch.Tensor, out: torch.Tensor,
                    plan) -> torch.Tensor:
    """K6's tangent mode: dout [R, D, G, W_max], the directional
    derivatives of :func:`fitted_eval` at ``dfs`` [R, G, L] (``out`` its
    value [R, G, W_max]) along D tangent rows a primal row ``ddfs``
    [R, D, G, L] (see ``fitted_rows.fitted_eval_jvp_plain``): one block a
    (primal row, tile of its directions, member), or a tile of primal rows
    with all their directions; the primal rows' transformed knots once a
    block, then each direction's tangent transforms, slopes (PCHIP's
    derivative, 0 where its guard is false; the spline's solve) and
    Hermite rows, times out fac; one ``torch.empty`` and one launch."""
    tab = plan.tables
    _fit_dfs(dfs, tab, "fitted_eval_jvp", 1)
    _fit_dfs(ddfs, tab, "fitted_eval_jvp", 2)
    R, D = ddfs.shape[:2]
    if dfs.shape[0] != R or ddfs.shape[-1] != dfs.shape[-1] \
            or tuple(out.shape) != (R, tab.G, tab.W_max):
        raise ValueError(f"fitted_eval_jvp: dfs {tuple(dfs.shape)}, ddfs "
                         f"{tuple(ddfs.shape)}, out {tuple(out.shape)}")
    if not dfs.is_cuda:
        from .fitted_rows import fitted_eval_jvp_plain
        return fitted_eval_jvp_plain(plan, dfs, ddfs, out, fitted_rows)
    dev = dfs.device
    for name, t, nd in (("dfs", dfs, 3), ("ddfs", ddfs, 4), ("out", out, 3)):
        _need(t, name, torch.float64, nd, dev)
    L = dfs.shape[-1]
    dout = torch.empty((R, D, tab.G, tab.W_max), dtype=torch.float64,
                       device=dev)
    if dout.numel() == 0:
        return dout
    if _lib is None:
        build_kernels()
    _check(_lib.fitted_eval_jvp_f64(
        dfs.data_ptr(), ddfs.data_ptr(), out.data_ptr(), R, D, tab.G, L,
        tab.n_max, tab.W_max, *_eval_tables(plan, dev), dout.data_ptr(),
        _stream(dev)), "fitted_eval_jvp_f64")
    fitted_eval_jvp.launches += 1
    return dout


fitted_eval_jvp.launches = 0


FIT_MODES = ("linear", "eval", "tangent")


def fitted_kernel_info(mode: str, R: int, G: int, n_max: int, W_max: int,
                       D: int = 0) -> dict:
    """K6's entry ``mode`` (``linear`` = :func:`fitted_rows`, ``eval`` =
    :func:`fitted_eval`, ``tangent`` = :func:`fitted_eval_jvp`):
    registers and local bytes a thread (``cudaFuncGetAttributes``), and
    the tiles of a launch of R rows (D directions) of G members of n_max
    knots and W_max queries: primal rows and directions a tile, blocks,
    shared memory bytes a block, whether the member's tables are staged
    in it, queries a tile (W_max unless one-row tiles leave SMs without a
    block)."""
    if _lib is None:
        build_kernels()
    out = (ctypes.c_int * 8)()
    _check(_lib.fitted_kernel_info(FIT_MODES.index(mode), R, D, G, n_max,
                                   W_max, out), "fitted_kernel_info")
    return dict(zip(("registers", "local_bytes", "tile_rows", "tile_dirs",
                     "blocks", "smem_bytes", "staged", "tile_queries"), out))


# ---------------------------------------------------------------------------
# K8-K12: the XCCY stage's directional derivatives and Hessians
# ---------------------------------------------------------------------------


class _XStage(ctypes.Structure):
    """csrc/xccy_stage.cu ``StageTab``: an ``XccyStageTables``' sizes and
    its tensors' device pointers, then the rows' node and band tables,
    then K9 / K11's lists over the legs, then K12's pillars and buckets."""
    _INTS = ("G", "S", "n", "U1", "Lf", "Ld", "W", "P", "Pd", "fsch",
             "dsch", "flags")
    _PTRS = ("pt_f", "pt_i", "v0", "fxs", "fq_i", "fq_f", "f_xs", "rq_i",
             "rq_f", "r_sch", "r_xs", "li_i", "li_f", "ld_i", "ld_f",
             "d_xs", "leg_f", "leg_s")
    _BAND_INTS = ("E", "NR", "NB")
    _BAND_PTRS = ("nr_ptr", "nr_row", "mb_pq", "mb_ptr", "mb_row",
                  "tp_off")
    _LEG_INTS = ("R", "NL", "EL", "NS", "nC", "NGD", "NMR", "NTT")
    _LEG_PTRS = ("lr_row", "lr_of", "ls_ptr", "ls_row", "lt_leg", "gd_ptr",
                 "gd_t", "me_rc", "mr_ptr", "mr_e", "lt_term", "sg",
                 "sc_ptr", "ts_ptr", "ts_seg")
    _NODE_INTS = ("NBT",)
    _NODE_PTRS = ("mat_pos", "nb_ptr", "nb_pt", "nb_pos", "cum_t", "pt_ord")
    _fields_ = ([(k, ctypes.c_int) for k in _INTS]
                + [(k, ctypes.c_void_p) for k in _PTRS]
                + [(k, ctypes.c_int) for k in _BAND_INTS]
                + [(k, ctypes.c_void_p) for k in _BAND_PTRS]
                + [(k, ctypes.c_int) for k in _LEG_INTS]
                + [(k, ctypes.c_void_p) for k in _LEG_PTRS]
                + [(k, ctypes.c_int) for k in _NODE_INTS]
                + [(k, ctypes.c_void_p) for k in _NODE_PTRS])


def _xstage(tab: xccy_stage.XccyStageTables) -> int:
    """The address of ``tab``'s argument block (built once, kept in
    ``tab.cache`` beside the tensors it points into)."""
    st = tab.cache.get("c")
    if st is None:
        ptrs = (_XStage._PTRS + _XStage._BAND_PTRS + _XStage._LEG_PTRS
                + _XStage._NODE_PTRS)
        for k in ptrs:
            t = getattr(tab, k)
            _need(t, k, torch.float64 if t.dtype == torch.float64
                  else torch.int32, t.dim(), tab.pt_f.device)
        sizes = dict(E=tab.E, NR=tab.nr_row.shape[1],
                     NB=tab.mb_row.shape[1], R=tab.lr_row.shape[1],
                     NL=tab.ls_row.shape[1], EL=tab.me_rc.shape[1],
                     NS=tab.sg.shape[1], nC=tab.sc_ptr.shape[1] // 2,
                     NGD=tab.gd_t.shape[1], NMR=tab.mr_e.shape[1],
                     NTT=tab.lt_term.shape[1], NBT=tab.nb_pt.shape[1])
        st = _XStage(**{k: getattr(tab, k) for k in _XStage._INTS},
                     **sizes, **{k: getattr(tab, k).data_ptr()
                                 for k in ptrs})
        tab.cache["c"] = st
    return ctypes.addressof(st)


_XCCY_KERNEL = dict(xccy_stage_jvp=8, xccy_legs_jvp=9, xccy_stage_hess=10,
                    xccy_legs_hess=11, xccy_stage_node_hess=12)


def xccy_kernel_info(tab, name: str) -> dict:
    """What the card's compiler and occupancy calculator say of kernel
    ``name`` (one of K8-K12's wrappers) at stage ``tab`` (on the card):
    its registers and local memory a thread (spills and stack; 0 when no
    thread keeps an array), and at this stage's sizes its dynamic shared
    memory a block, the blocks an SM holds at once, its threads a block,
    K8 / K10 / K12's tile of directions, which of the grid's transforms,
    the chain tables, the foreign tangent rows, K10 / K12's tape of primal
    exps and quotients and K10's node and band lists their blocks hold in
    shared memory (``held``; the others are read from device memory, the tape's
    values computed by every thread) and their blocks a (scenario,
    member); for K9 / K11 at the stage's Qd domestic directions, which of
    the domestic grid's transforms and the tangent rows their blocks hold
    in shared memory and K11's directions a tile of U. K12 runs two
    launches: its registers and local bytes are the most of the two, its
    blocks an SM the fewer, its shared bytes and threads the pair
    launch's, ``tile`` its directions a tile, ``blocks_per_member`` the
    prologue's blocks a (scenario, member), ``held`` what the prologue's
    blocks hold; ``warps`` a pair block, ``blocks`` the pair launch's
    blocks at one scenario, and ``prologue`` / ``pairs`` each launch's
    registers, local bytes, shared bytes and blocks an SM (and the
    prologue's warps a block)."""
    if _lib is None:
        build_kernels()
    out = (ctypes.c_int * 19)()
    k = _XCCY_KERNEL[name]
    _check(_lib.xccy_kernel_info(_xstage(tab), tab.Qd if k in (9, 11)
                                 else tab.D, k, int(tab.recal), out),
           "xccy_kernel_info")
    keys = ("registers", "local_bytes", "smem_bytes", "blocks_per_sm")
    info = dict(zip(keys + ("threads", "tile"), list(out)[:6]))
    info["held"] = [k for b, k in ((1, "grid"), (2, "chain"), (4, "rows"),
                                   (8, "tape"), (16, "lists"))
                    if out[6] & b]
    info["blocks_per_member"] = out[7]
    if k == 12:
        info.update(prologue=dict(zip(keys, list(out)[8:12]),
                                  warps=out[18]),
                    pairs=dict(zip(keys, list(out)[12:16])),
                    blocks=out[16], warps=out[17])
    return info


def _xshape(t, name: str, shape):
    if t is None or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape "
                         f"{None if t is None else tuple(t.shape)}, "
                         f"expected {tuple(shape)}")


def _xlaunch(entry: str, tab, *args):
    if _lib is None:
        build_kernels()
    _check(getattr(_lib, entry)(_xstage(tab), *args,
                                _stream(tab.pt_f.device)), entry)


def _xin(t: torch.Tensor, name: str, dev):
    _need(t, name, torch.float64, t.dim(), dev)
    return t.data_ptr()


def xccy_stage_jvp(tab, sp: torch.Tensor, pv: torch.Tensor,
                   fd: torch.Tensor, tf=None):
    """K8: (ds [Sc, G, U1], rows [Sc, G, W], drows [Sc, D, G, W]), the
    stage's native DFs, rows and the rows' directional derivatives along
    its D directions (see ``xccy_stage.xccy_stage_jvp_plain``), from sp,
    pv [Sc, G, S], fd [Sc, G, Lf] and tf [Sc, D, G, Lf] (None when the
    parents are held as values): a block a (scenario, member, tile of
    directions) runs a dual chain a direction to the node DFs, then the
    rows once and their tangents from the nodes'; three ``torch.empty``
    and one launch."""
    Sc, G, S = sp.shape[0], tab.G, tab.S
    _xshape(sp, "sp", (Sc, G, S))
    _xshape(pv, "pv", (Sc, G, S))
    _xshape(fd, "fd", (Sc, G, tab.Lf))
    if tab.recal:
        _xshape(tf, "tf", (Sc, tab.D, G, tab.Lf))
    elif tf is not None:
        raise ValueError("tf: the parents are held as values")
    if not sp.is_cuda:
        return xccy_stage.xccy_stage_jvp_plain(tab, sp, pv, fd, tf)
    dev = sp.device
    ds = torch.empty((Sc, G, tab.U1), dtype=torch.float64, device=dev)
    rows = torch.empty((Sc, G, tab.W), dtype=torch.float64, device=dev)
    drows = torch.empty((Sc, tab.D, G, tab.W), dtype=torch.float64,
                        device=dev)
    if Sc:
        _xlaunch("xccy_stage_jvp_f64", tab, Sc, tab.D, tab.npv,
                 _xin(sp, "sp", dev), _xin(pv, "pv", dev),
                 _xin(fd, "fd", dev),
                 None if tf is None else _xin(tf, "tf", dev),
                 ds.data_ptr(), rows.data_ptr(), drows.data_ptr())
        xccy_stage_jvp.launches += 1
    return ds, rows, drows


xccy_stage_jvp.launches = 0


def xccy_legs_jvp(tab, dd: torch.Tensor, tdl: torch.Tensor):
    """K9: (pv0 [Sc, G, S], Jpv [Sc, Qd, G, S]), the calibration legs'
    PVs and their directional derivatives along the domestic tangents
    tdl [Sc, Qd, G, Ld] at dd [Sc, G, Ld] (see
    ``xccy_stage.xccy_legs_jvp_plain``): a block a (scenario, member)
    evaluates the legs' flows once, collapses their gradients onto the
    domestic grid's rows and takes Jpv[d, s] = G_s . t_d; two
    ``torch.empty`` and one launch."""
    Sc, G = dd.shape[0], tab.G
    _xshape(dd, "dd", (Sc, G, tab.Ld))
    _xshape(tdl, "tdl", (Sc, tab.Qd, G, tab.Ld))
    if not dd.is_cuda:
        return xccy_stage.xccy_legs_jvp_plain(tab, dd, tdl)
    dev = dd.device
    pv0 = torch.empty((Sc, G, tab.S), dtype=torch.float64, device=dev)
    jpv = torch.empty((Sc, tab.Qd, G, tab.S), dtype=torch.float64,
                      device=dev)
    if Sc and tab.Qd:
        _xlaunch("xccy_legs_jvp_f64", tab, Sc, tab.Qd, _xin(dd, "dd", dev),
                 _xin(tdl, "tdl", dev), pv0.data_ptr(), jpv.data_ptr())
        xccy_legs_jvp.launches += 1
    return pv0, jpv


xccy_legs_jvp.launches = 0


def xccy_stage_hess(tab, sp: torch.Tensor, pv: torch.Tensor,
                    fd: torch.Tensor, tf, gs: torch.Tensor):
    """K10: (gZ [Sc, G, D], gf [Sc, G, Lf] or None, H [Sc, D, G, D]) for
    s(Z, fd) = sum(gs . rows) at Z = 0 over the stage's D directions and
    its foreign grid (see ``xccy_stage.xccy_stage_hess_plain``; ``gs``
    [Sc, G, W]): a block a (scenario, member, tile pair) runs a dual
    chain a direction, sums a = ds/dds and the band of M = d2s/dds2 over
    the rows, then a hyper-dual chain a pair i <= j (each pair once, in
    the kernel's own enumeration), writing H at [i, j] and [j, i] (and gZ
    at i = j); recalibrated, a block a (scenario, member, 128 foreign grid
    entries) gives gf by a dual chain an entry; three ``torch.empty`` and
    one launch."""
    Sc, G = sp.shape[0], tab.G
    _xshape(gs, "gs", (Sc, G, tab.W))
    _xshape(sp, "sp", (Sc, G, tab.S))
    _xshape(pv, "pv", (Sc, G, tab.S))
    _xshape(fd, "fd", (Sc, G, tab.Lf))
    if tab.recal:
        _xshape(tf, "tf", (Sc, tab.D, G, tab.Lf))
    elif tf is not None:
        raise ValueError("tf: the parents are held as values")
    if not sp.is_cuda:
        return xccy_stage.xccy_stage_hess_plain(tab, sp, pv, fd, tf, gs)
    dev = sp.device
    gZ = torch.empty((Sc, G, tab.D), dtype=torch.float64, device=dev)
    gf = torch.empty((Sc, G, tab.Lf), dtype=torch.float64, device=dev)
    H = torch.empty((Sc, tab.D, G, tab.D), dtype=torch.float64, device=dev)
    if Sc:
        _xlaunch("xccy_stage_hess_f64", tab, Sc, tab.D, tab.npv,
                 tab.Lf if tab.recal else 0, _xin(sp, "sp", dev),
                 _xin(pv, "pv", dev), _xin(fd, "fd", dev),
                 None if tf is None else _xin(tf, "tf", dev),
                 _xin(gs, "gs", dev), gZ.data_ptr(), gf.data_ptr(),
                 H.data_ptr())
        xccy_stage_hess.launches += 1
    return gZ, (gf if tab.recal else None), H


xccy_stage_hess.launches = 0


def xccy_legs_hess(tab, dd: torch.Tensor, tdl: torch.Tensor,
                   gpv: torch.Tensor):
    """K11: (gdd [Sc, G, Ld], Hl [Sc, Qd, G, Qd]) for s(Zd, dd) =
    sum(gpv . legs(dd + Zd . tdl)) at Zd = 0 (see
    ``xccy_stage.xccy_legs_hess_plain``; gpv [Sc, G, S]): a block a
    (scenario, member) evaluates the legs' flows once, collapses gdd and
    the gpv-weighted Hessian M onto the domestic grid's rows, then takes
    U = M T' and each pair i <= j once as t_i . U_j, written at [i, j]
    and [j, i] (the kernel enumerates the pairs); two ``torch.empty`` and
    one launch."""
    Sc, G = dd.shape[0], tab.G
    _xshape(dd, "dd", (Sc, G, tab.Ld))
    _xshape(tdl, "tdl", (Sc, tab.Qd, G, tab.Ld))
    _xshape(gpv, "gpv", (Sc, G, tab.S))
    if not dd.is_cuda:
        return xccy_stage.xccy_legs_hess_plain(tab, dd, tdl, gpv)
    dev = dd.device
    gdd = torch.empty((Sc, G, tab.Ld), dtype=torch.float64, device=dev)
    Hl = torch.empty((Sc, tab.Qd, G, tab.Qd), dtype=torch.float64,
                     device=dev)
    if Sc:
        _xlaunch("xccy_legs_hess_f64", tab, Sc, tab.Qd, tab.Ld,
                 _xin(dd, "dd", dev), _xin(tdl, "tdl", dev),
                 _xin(gpv, "gpv", dev), gdd.data_ptr(), Hl.data_ptr())
        xccy_legs_hess.launches += 1
    return gdd, Hl


xccy_legs_hess.launches = 0


def xccy_stage_node_hess(tab, sp: torch.Tensor, pv: torch.Tensor,
                         fd: torch.Tensor, tf=None):
    """K12: (ds [Sc, G, U1], Jn [Sc, D, G, U1], Jfd [Sc, Lf, G, U1] or
    None, Hn [Sc, D, D, G, U1]), the stage's node DFs, their first
    tangents along its D directions, along each unit entry of its foreign
    grid (recalibrated) and their second derivatives in each pair of
    directions (see ``xccy_stage.xccy_stage_node_hess_plain``), from sp,
    pv [Sc, G, S], fd [Sc, G, Lf] and tf [Sc, D, G, Lf] (None when the
    parents are held as values): a chain a warp, its lanes on the chain
    points; a prologue launch runs the primal chain and a dual chain a
    direction and a foreign grid entry once a (scenario, member) (ds, Jn,
    Jfd and the tables of a workspace), then a launch runs a hyper-dual
    chain a pair i <= j (each pair once; a block a (scenario, member) and
    tile pair of directions), writing its nodes at [i, j] and [j, i]; five
    ``torch.empty`` (the outputs and the workspace,
    ``xccy_stage.node_workspace`` doubles a (scenario, member)) and two
    launches, counted as one call."""
    Sc, G, S = sp.shape[0], tab.G, tab.S
    _xshape(sp, "sp", (Sc, G, S))
    _xshape(pv, "pv", (Sc, G, S))
    _xshape(fd, "fd", (Sc, G, tab.Lf))
    if tab.recal:
        _xshape(tf, "tf", (Sc, tab.D, G, tab.Lf))
    elif tf is not None:
        raise ValueError("tf: the parents are held as values")
    if not sp.is_cuda:
        return xccy_stage.xccy_stage_node_hess_plain(tab, sp, pv, fd, tf)
    dev = sp.device
    D, U1 = tab.D, tab.U1
    ds = torch.empty((Sc, G, U1), dtype=torch.float64, device=dev)
    jn = torch.empty((Sc, D, G, U1), dtype=torch.float64, device=dev)
    jfd = torch.empty((Sc, tab.Lf, G, U1), dtype=torch.float64, device=dev)
    hn = torch.empty((Sc, D, D, G, U1), dtype=torch.float64, device=dev)
    nw = xccy_stage.node_workspace(tab)
    ws = torch.empty((Sc, G, nw), dtype=torch.float64, device=dev)
    if Sc:
        _xlaunch("xccy_stage_node_hess_f64", tab, Sc, D, tab.npv,
                 tab.Lf if tab.recal else 0, _xin(sp, "sp", dev),
                 _xin(pv, "pv", dev), _xin(fd, "fd", dev),
                 None if tf is None else _xin(tf, "tf", dev),
                 ds.data_ptr(), jn.data_ptr(), jfd.data_ptr(), hn.data_ptr(),
                 ws.data_ptr(), nw)
        xccy_stage_node_hess.launches += 1
    return ds, jn, (jfd if tab.recal else None), hn


xccy_stage_node_hess.launches = 0


# ---------------------------------------------------------------------------
# K13 / K14: the OIS stage's directional derivatives and Hessian
# ---------------------------------------------------------------------------


class _OStage(ctypes.Structure):
    """csrc/ois_stage.cu ``OisStageTab``: an ``OisStageTables``' sizes and
    its tensors' device pointers, then the list widths and the band's
    tables."""
    _INTS = ("G", "P", "P1", "Qp", "W", "E", "log")
    _PTRS = ("pt_f", "pt_i", "ch_ptr", "ch_pt", "pad", "rq_i", "rq_f",
             "r_sch", "r_xs")
    _WIDTHS = ("NC", "NE")
    _BAND_PTRS = ("mb_pq", "r_e", "nb_ptr", "nb_e")
    _fields_ = ([(k, ctypes.c_int) for k in _INTS]
                + [(k, ctypes.c_void_p) for k in _PTRS]
                + [(k, ctypes.c_int) for k in _WIDTHS]
                + [(k, ctypes.c_void_p) for k in _BAND_PTRS])


def _ostage(tab: ois_stage.OisStageTables) -> int:
    """The address of ``tab``'s argument block (built once, kept in
    ``tab.cache`` beside the tensors it points into)."""
    st = tab.cache.get("c")
    if st is None:
        ptrs = _OStage._PTRS + _OStage._BAND_PTRS
        for k in ptrs:
            t = getattr(tab, k)
            _need(t, k, torch.float64 if t.dtype == torch.float64
                  else torch.int32, t.dim(), tab.pt_f.device)
        st = _OStage(G=tab.G, P=tab.P, P1=tab.P1, Qp=tab.Qp, W=tab.W,
                     E=tab.E, log=int(tab.log), NC=tab.ch_pt.shape[1],
                     NE=tab.nb_e.shape[1],
                     **{k: getattr(tab, k).data_ptr() for k in ptrs})
        tab.cache["c"] = st
    return ctypes.addressof(st)


def _outside_transforms(what: str, *ts):
    """K13 / K14 take plain tensors: raise LibError under a forward-mode
    transform or for a batched input (a ctypes launch sees neither)."""
    from torch._C._functorch import is_batchedtensor

    from .linear_solve import forward_levels
    if forward_levels() > 0 or any(is_batchedtensor(t) for t in ts):
        raise LibError(f"{what} runs outside torch.func transforms: it is a "
                       f"derivative itself, with no rule of its own")


def ois_kernel_info(tab, name: str) -> dict:
    """What the card's compiler and occupancy calculator say of K13
    (``ois_stage_jvp``) or K14 (``ois_stage_hess``) at stage ``tab`` (on
    the card): registers and local memory a thread (0 when no thread
    keeps an array), and at this stage's sizes the dynamic shared memory
    a block (one (scenario, member)), the blocks an SM holds at once and
    the threads a block."""
    if _lib is None:
        build_kernels()
    out = (ctypes.c_int * 5)()
    _check(_lib.ois_kernel_info(_ostage(tab), 13 if name == "ois_stage_jvp"
                                else 14, out), "ois_kernel_info")
    return dict(zip(("registers", "local_bytes", "smem_bytes",
                     "blocks_per_sm", "threads"), list(out)))


def ois_stage_jvp(tab, q: torch.Tensor):
    """K13: (ds [Sc, G, P1], rows [Sc, G, W], dds [Sc, Qp, G, P1], drows
    [Sc, Qp, G, W]), the stage's native DFs, rows and their directional
    derivatives along the Qp unit quote directions (see
    ``ois_stage.ois_stage_jvp_plain``), from the local quotes q [Sc, G,
    Qp]: a block a (scenario, member), a lane of its first warp a
    direction walking the chain in dual numbers, then its threads on the
    rows; four ``torch.empty`` and one launch. Outside torch.func
    transforms only."""
    _outside_transforms("ois_stage_jvp", q)
    Sc, G, P1, W, Qp = q.shape[0], tab.G, tab.P1, tab.W, tab.Qp
    _xshape(q, "q", (Sc, G, Qp))
    if not q.is_cuda:
        return ois_stage.ois_stage_jvp_plain(tab, q)
    dev = q.device
    ds = torch.empty((Sc, G, P1), dtype=torch.float64, device=dev)
    rows = torch.empty((Sc, G, W), dtype=torch.float64, device=dev)
    dds = torch.empty((Sc, Qp, G, P1), dtype=torch.float64, device=dev)
    drows = torch.empty((Sc, Qp, G, W), dtype=torch.float64, device=dev)
    if Sc:
        if _lib is None:
            build_kernels()
        _check(_lib.ois_stage_jvp_f64(
            _ostage(tab), Sc, _xin(q, "q", dev), ds.data_ptr(),
            rows.data_ptr(), dds.data_ptr(), drows.data_ptr(),
            _stream(dev)), "ois_stage_jvp_f64")
        ois_stage_jvp.launches += 1
    return ds, rows, dds, drows


ois_stage_jvp.launches = 0


def ois_stage_hess(tab, q: torch.Tensor, gs: torch.Tensor,
                   vs: torch.Tensor) -> torch.Tensor:
    """K14: Hs [Sc, Qp, G, Qp], the Hessian over the local quotes q [Sc,
    G, Qp] of psi = sum(gs * rows) + sum(vs * ds) (gs [Sc, G, W], vs
    [Sc, G, P1]; see ``ois_stage.ois_stage_hess_plain``): a block a
    (scenario, member) sums the node cotangent and the rows' band once,
    its warps on the rows, then a lane of its first warp a direction runs
    the dual chain and its adjoint in reverse order in dual numbers; one
    ``torch.empty`` and one launch.
    Outside torch.func transforms only."""
    _outside_transforms("ois_stage_hess", q, gs, vs)
    Sc, G, Qp = q.shape[0], tab.G, tab.Qp
    _xshape(q, "q", (Sc, G, Qp))
    _xshape(gs, "gs", (Sc, G, tab.W))
    _xshape(vs, "vs", (Sc, G, tab.P1))
    if not q.is_cuda:
        return ois_stage.ois_stage_hess_plain(tab, q, gs, vs)
    dev = q.device
    Hs = torch.empty((Sc, Qp, G, Qp), dtype=torch.float64, device=dev)
    if Sc:
        if _lib is None:
            build_kernels()
        _check(_lib.ois_stage_hess_f64(
            _ostage(tab), Sc, _xin(q, "q", dev), _xin(gs, "gs", dev),
            _xin(vs, "vs", dev), Hs.data_ptr(), _stream(dev)),
            "ois_stage_hess_f64")
        ois_stage_hess.launches += 1
    return Hs


ois_stage_hess.launches = 0
