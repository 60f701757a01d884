"""The hand-written CUDA kernels of the book path, their plain torch
twins, and the build that binds them.

K1 ``pvs_sweep`` (``csrc/pvs_sweep.cu``) replaces
``adrates_tpu/parallel/multibook.py:_pvs_sweep`` (:1782, the gather and
row/trade sums). K2 ``gamma_quad_form_grouped``
(``csrc/gamma_quad_form.cu``) replaces ``_gamma_quad_form_grouped``
(:1660, the trip term). Both are forward-only (their derivatives are
closed form elsewhere), f64 throughout, and each source file says what
bounds it on the card and how its design answers that.

Dispatch: a wrapper given CPU tensors runs the plain twin; given CUDA
tensors it launches the kernel or raises. Nothing falls back. Each
wrapper counts its kernel launches in ``<wrapper>.launches`` (a plain
int; the plain path never touches it).

Build: at first use on a CUDA tensor, ``nvcc`` compiles every ``*.cu``
under ``adrates_torch/csrc`` for ``sm_90a`` into one shared library with
a plain C interface under ``adrates_torch/_build``, named by a hash of the
sources and flags, and ``ctypes`` loads it. Nothing is built at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Sequence, Tuple

import torch

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "pvs_rows_f64": [_P, _I, _P, _P, _I, _I, _P, _P],
    "pvs_trades_f64": [_P, _I, _P, _I, _I, _P, _P],
    "gamma_group_f64": [_P, _P, _I, _I, _I, _P, _P, _P, _P, _I, _P, _I,
                        _P, _P],
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
    for src in sorted(_CSRC.glob("*.cu")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _BUILD / f"libadrates_kernels_{h.hexdigest()[:16]}.so"


def build_kernels() -> float:
    """Compile (if needed) and load the kernels; returns the seconds it
    took. Raises if nvcc fails."""
    global _lib
    t0 = time.perf_counter()
    if _lib is None:
        so = library_path()
        if not so.exists():
            _BUILD.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp),
                   *[str(p) for p in sorted(_CSRC.glob("*.cu"))]]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
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


# ---------------------------------------------------------------------------
# K1: per-trade PV sweep
# ---------------------------------------------------------------------------


def pvs_sweep_plain(vT: torch.Tensor,
                    buckets: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                    tri: torch.Tensor) -> torch.Tensor:
    """Plain twin of K1, written from ``_pvs_sweep``: the [B, S] trade
    PVs from the [M, S] value table, the column buckets' (col_idx [R, L],
    w [R, L]) slots and the [B, K] trade row table over the concatenated
    rows (dead slots index the appended zero row)."""
    S = vT.shape[1]
    rowpvs = []
    for ci, wi in buckets:
        R, L = ci.shape
        ci = ci.long()
        # bound the [chunk, L, S] gathered temporary near 200 MB f64
        chunk = max(1, min(R, int(2.5e7 // max(L * S, 1))))
        for r0 in range(0, R, chunk):
            c = ci[r0:r0 + chunk]
            Y = vT[c.reshape(-1)].reshape(c.shape + (S,))
            rowpvs.append(torch.sum(wi[r0:r0 + chunk, :, None] * Y, dim=1))
    rowpvs.append(torch.zeros((1, S), dtype=vT.dtype, device=vT.device))
    rowpv = torch.cat(rowpvs)
    return torch.sum(rowpv[tri.long()], dim=1)


def pvs_sweep(vT: torch.Tensor,
              buckets: Sequence[Tuple[torch.Tensor, torch.Tensor]],
              tri: torch.Tensor) -> torch.Tensor:
    """K1: [B, S] trade PVs (see :func:`pvs_sweep_plain`). ``col_idx`` and
    ``tri`` are int32, ``vT`` and ``w`` f64, all contiguous on one
    device."""
    if not vT.is_cuda:
        return pvs_sweep_plain(vT, buckets, tri)
    dev = vT.device
    _need(vT, "vT", torch.float64, 2, dev)
    _need(tri, "tri", torch.int32, 2, dev)
    M, S = vT.shape
    R_total = 0
    for n, (ci, wi) in enumerate(buckets):
        _need(ci, f"col_idx[{n}]", torch.int32, 2, dev)
        _need(wi, f"w[{n}]", torch.float64, 2, dev)
        if ci.shape != wi.shape:
            raise ValueError(f"bucket {n}: col_idx {tuple(ci.shape)} vs "
                             f"w {tuple(wi.shape)}")
        R_total += ci.shape[0]
    build_kernels()
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    rowpv = torch.empty((R_total + 1, S), dtype=torch.float64, device=dev)
    rowpv[R_total].zero_()
    off = 0
    for ci, wi in buckets:
        R, L = ci.shape
        _check(_lib.pvs_rows_f64(vT.data_ptr(), S, ci.data_ptr(),
                                 wi.data_ptr(), R, L,
                                 rowpv[off:].data_ptr(), stream),
               "pvs_rows_f64")
        pvs_sweep.launches += 1
        off += R
    B, K = tri.shape
    out = torch.empty((B, S), dtype=torch.float64, device=dev)
    _check(_lib.pvs_trades_f64(rowpv.data_ptr(), S, tri.data_ptr(), B, K,
                               out.data_ptr(), stream), "pvs_trades_f64")
    pvs_sweep.launches += 1
    return out


pvs_sweep.launches = 0


# ---------------------------------------------------------------------------
# K2: grouped term-1 quad form
# ---------------------------------------------------------------------------


def gamma_quad_form_grouped_plain(J: torch.Tensor, dfs: torch.Tensor,
                                  groups: Sequence[dict]) -> torch.Tensor:
    """Plain twin of K2, written from ``_gamma_quad_form_grouped``:
    J [S, N, n_grid], dfs [S, n_grid] and the trip groups (dicts of
    ``s_idx``, ``e_idx``, ``p_idx``, ``rows`` index tensors and ``w``
    weights) -> the trip term of Jᵀ·H_agg·J, [S, N, N].

    A trip's value (a/b - 1) c has the second differential
    2 du (dc - (c/b) db) with du = (da - (a/b) db)/b, so its block is
    the rank-2 form w (X Yᵀ + Y Xᵀ) with X = (Ja - (a/b) Jb)/b and
    Y = Jc - (c/b) Jb. That is the JAX package's four-product form
    (f_ab, f_ac, f_bc, f_bb) regrouped: the near-cancelling Ja/Jb terms
    of a short accrual period cancel once, in X, instead of across four
    accumulated products."""
    S, N, n_grid = J.shape
    G = torch.zeros((S, N, N), dtype=J.dtype, device=J.device)
    Jf = J.reshape(S, -1)
    for g in groups:
        s_i, e_i, p_i = g["s_idx"].long(), g["e_idx"].long(), \
            g["p_idx"].long()
        rows = g["rows"].long()
        a, b, c = dfs[:, s_i], dfs[:, e_i], dfs[:, p_i]      # [S, T_g]
        base = rows[:, None] * n_grid
        Ja = Jf[:, base + s_i[None, :]]                       # [S, k, T_g]
        Jb = Jf[:, base + e_i[None, :]]
        Jc = Jf[:, base + p_i[None, :]]
        X = (Ja - (a / b)[:, None, :] * Jb) * (1.0 / b)[:, None, :]
        Y = Jc - (c / b)[:, None, :] * Jb
        Z = (X * g["w"][None, None, :]) @ Y.transpose(1, 2)
        G[:, rows[:, None], rows[None, :]] += Z + Z.transpose(1, 2)
    return G


def gamma_quad_form_grouped(J: torch.Tensor, dfs: torch.Tensor,
                            groups: Sequence[dict]) -> torch.Tensor:
    """K2: the [S, N, N] trip term (see
    :func:`gamma_quad_form_grouped_plain`). On CUDA the group index
    tensors are int32 and ``w`` f64, all contiguous on J's device."""
    if not J.is_cuda:
        return gamma_quad_form_grouped_plain(J, dfs, groups)
    dev = J.device
    _need(J, "J", torch.float64, 3, dev)
    _need(dfs, "dfs", torch.float64, 2, dev)
    S, N, n_grid = J.shape
    if tuple(dfs.shape) != (S, n_grid):
        raise ValueError(f"dfs {tuple(dfs.shape)} vs J {tuple(J.shape)}")
    if S > 65535:
        raise ValueError(f"{S} scenarios exceed one launch's grid z")
    for n, g in enumerate(groups):
        for key in ("s_idx", "e_idx", "p_idx", "rows"):
            _need(g[key], f"groups[{n}].{key}", torch.int32, 1, dev)
        _need(g["w"], f"groups[{n}].w", torch.float64, 1, dev)
        if g["w"].shape != g["s_idx"].shape:
            raise ValueError(f"groups[{n}]: w and s_idx lengths differ")
    build_kernels()
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    G = torch.zeros((S, N, N), dtype=torch.float64, device=dev)
    for g in groups:
        T = g["s_idx"].shape[0]
        k = g["rows"].shape[0]
        _check(_lib.gamma_group_f64(
            J.data_ptr(), dfs.data_ptr(), S, N, n_grid,
            g["s_idx"].data_ptr(), g["e_idx"].data_ptr(),
            g["p_idx"].data_ptr(), g["w"].data_ptr(), T,
            g["rows"].data_ptr(), k, G.data_ptr(), stream),
            "gamma_group_f64")
        gamma_quad_form_grouped.launches += 1
    return G


gamma_quad_form_grouped.launches = 0
