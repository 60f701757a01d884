"""Differentiable OIS curve bootstrap — static point plan + K-sweep solve.

Port of ``adrates_tpu/ops/bootstrap.py``. The plan builder is the same
host numpy code (copied verbatim, including the reference's 2-decimal
rounded-key memo and the ``searchsorted(side="right")`` rate weights).
The solve is torch:

    pv01_i = (pv01_prev(i) + acc_i) / (1 + r_i * acc_i)

is the linear triangular system (I - A) pv01 = b with
A x = gather(x, prev)/denom and b = accs/denom. A is nilpotent (chains
point strictly backward, at most ``depth`` long), so K = depth Horner
sweeps x <- b + A x give the exact solution. Autograd differentiates
through the sweeps directly: the K-sweep polynomial equals (I - A)^-1 b
for every A with this sparsity, so its derivatives of every order are
the exact implicit-function derivatives — no custom linear solve needed.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class OISBootstrapPlan:
    """Static topology of an OIS bootstrap. Fields are numpy arrays on the
    host (see :func:`plan_to_torch` for the device form); a stacked plan
    has a leading [G] curve axis on every array.

    point_times: [P] exact time of each bootstrap point (sorted ascending)
    accs:        [P] accrual fraction of the period ending at the point
    prev_idx:    [P] index of the previous coupon's point (-1 → pv01 = 0)
    pillar_idx:  [P] index into the pillar rate vector when the point is a
                 pillar maturity, else -1 (rate comes from log-linear
                 interpolation of pillar rates at point_times)
    swap_times:  [S] pillar maturities (interpolation x-grid)
    pillar_point:[S] index of each pillar's point in the point arrays
    depth:       max dependency-chain length (number of sweeps)
    loglinear_rates: interpolate sub-pillar rates in log space
    rate_i0/rate_i1/rate_c: [P] static sub-pillar rate-interpolation
                 bracket and weight (same for log and linear space)
    """
    point_times: np.ndarray
    accs: np.ndarray
    prev_idx: np.ndarray
    pillar_idx: np.ndarray
    swap_times: np.ndarray
    pillar_point: np.ndarray
    depth: int = 0
    loglinear_rates: bool = True
    rate_i0: np.ndarray = None
    rate_i1: np.ndarray = None
    rate_c: np.ndarray = None


def prepare_ois_plan(swap_times: Sequence[float],
                     year_fracs: Sequence[Sequence[float]],
                     loglinear_rates: bool = True) -> OISBootstrapPlan:
    """Expand calibration swaps into the static bootstrap point plan.

    Runs once per curve topology in Python. Reproduces the reference's
    rounded-2dp memo: a sub-pillar coupon point is created only when no
    point with the same rounded cumulative-time key exists yet; pillar
    points always exist and take ownership of their key.
    """
    points: List[dict] = []
    by_key = {}          # rounded key -> point index
    ROUND = 2

    def key_of(t: float) -> float:
        return round(t, ROUND)

    for i, fracs in enumerate(year_fracs):
        cum = 0.0
        prev_point = -1  # pv01 = 0 base
        for j, frac in enumerate(fracs):
            cum += float(frac)
            k = key_of(cum)
            is_final = (j == len(fracs) - 1)
            if is_final:
                # Pillar point: exact time is the swap's quoted maturity
                # time (last coupon date), not the year-frac cumsum
                # (ois_curve.py:141-148).
                t_point = float(swap_times[i])
                points.append(dict(t=t_point, acc=float(frac),
                                   prev=prev_point, pillar=i))
                by_key[k] = len(points) - 1
                prev_point = len(points) - 1
            else:
                if k in by_key:
                    prev_point = by_key[k]
                else:
                    points.append(dict(t=cum, acc=float(frac),
                                       prev=prev_point, pillar=-1))
                    by_key[k] = len(points) - 1
                    prev_point = len(points) - 1

    # Sort by time, remapping dependency links.
    order = sorted(range(len(points)), key=lambda idx: points[idx]["t"])
    remap = {old: new for new, old in enumerate(order)}
    sorted_points = [points[old] for old in order]

    point_times = np.array([p["t"] for p in sorted_points])
    accs = np.array([p["acc"] for p in sorted_points])
    prev_idx = np.array([remap[p["prev"]] if p["prev"] >= 0 else -1
                         for p in sorted_points], dtype=np.int32)
    pillar_idx = np.array([p["pillar"] for p in sorted_points],
                          dtype=np.int32)
    pillar_point = np.full(len(swap_times), -1, dtype=np.int32)
    for idx, p in enumerate(sorted_points):
        if p["pillar"] >= 0:
            pillar_point[p["pillar"]] = idx

    # Dependencies must point strictly backward (DAG, no cycles).
    if not np.all(prev_idx < np.arange(len(sorted_points))):
        raise ValueError("bootstrap dependency cycle — check calibration "
                         "swap ordering")

    # Max chain depth: number of sweeps needed to settle.
    depths = np.zeros(len(sorted_points), dtype=np.int64)
    for idx in range(len(sorted_points)):
        p = prev_idx[idx]
        depths[idx] = 1 if p < 0 else depths[p] + 1
    depth = int(depths.max()) if len(sorted_points) else 0

    sw = np.asarray(swap_times, dtype=float)
    ri = np.clip(np.searchsorted(sw, point_times, side="right"), 1,
                 max(sw.shape[0] - 1, 1))
    ri0 = (ri - 1).astype(np.int64)
    ri1 = ri.astype(np.int64)
    dx = sw[ri1] - sw[ri0]
    dx0 = np.abs(dx) <= np.spacing(np.finfo(np.float64).eps)
    rc = np.where(dx0, 0.0,
                  (point_times - sw[ri0]) / np.where(dx0, 1.0, dx))
    lo = point_times < sw[0]
    hi = point_times > sw[-1]
    ri0[lo] = 0
    ri1[lo] = 0
    ri0[hi] = sw.shape[0] - 1
    ri1[hi] = sw.shape[0] - 1
    rc[lo | hi] = 0.0

    return OISBootstrapPlan(point_times=point_times, accs=accs,
                            prev_idx=prev_idx, pillar_idx=pillar_idx,
                            swap_times=sw, pillar_point=pillar_point,
                            depth=depth, loglinear_rates=loglinear_rates,
                            rate_i0=ri0.astype(np.int32),
                            rate_i1=ri1.astype(np.int32), rate_c=rc)


def plan_to_torch(plan: OISBootstrapPlan, device) -> dict:
    """The plan's arrays as tensors on ``device`` (indices int64, times
    and weights f64), plus its two static switches."""
    def f64(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64),
                               device=device)

    def i64(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)

    return dict(point_times=f64(plan.point_times), accs=f64(plan.accs),
                prev_idx=i64(plan.prev_idx), pillar_idx=i64(plan.pillar_idx),
                rate_i0=i64(plan.rate_i0), rate_i1=i64(plan.rate_i1),
                rate_c=f64(plan.rate_c), pillar_point=i64(plan.pillar_point),
                depth=int(plan.depth),
                loglinear_rates=bool(plan.loglinear_rates))


def bootstrap_ois(rates: torch.Tensor, plan: dict):
    """Solve the bootstrap: pillar rates -> (times, dfs) dense grid.

    ``plan`` is a :func:`plan_to_torch` dict. ``rates`` is [Q] with a
    single plan, or [G, Q] with a stacked [G, ...] plan (one curve per
    row). Differentiable w.r.t. ``rates``; returns times/dfs WITH the
    t=0 node (df=1) prepended.
    """
    times = plan["point_times"]
    accs = plan["accs"]
    prev_idx = plan["prev_idx"]
    pillar_idx = plan["pillar_idx"]
    ri0, ri1, rc = plan["rate_i0"], plan["rate_i1"], plan["rate_c"]

    def interp_static(y):
        y0 = y.gather(-1, ri0)
        return y0 + rc * (y.gather(-1, ri1) - y0)

    # Sub-pillar rates: log-linear in the pillar rates, falling back to
    # linear space when any pillar rate is non-positive. The clamp floor
    # must keep 1/safe**2 finite so every AD order stays finite: 1e-8
    # (0.0001 bp) only bites where log-linear interpolation is
    # numerically meaningless anyway.
    if plan["loglinear_rates"]:
        safe = torch.clamp(rates, min=1e-8)
        log_interp = torch.exp(interp_static(torch.log(safe)))
        lin_interp = interp_static(rates)
        interp_rates = torch.where(
            torch.all(rates > 0.0, dim=-1, keepdim=True), log_interp,
            lin_interp)
    else:
        interp_rates = interp_static(rates)
    point_rates = torch.where(pillar_idx >= 0,
                              rates.gather(-1, pillar_idx.clamp(min=0)),
                              interp_rates)

    denom = 1.0 + point_rates * accs            # [.., P], exact
    has_prev = prev_idx >= 0
    gather_idx = prev_idx.clamp(min=0)

    def A(x):
        return torch.where(has_prev, x.gather(-1, gather_idx), 0.0) / denom

    # K Horner sweeps of the Neumann series, exact after K = depth
    # sweeps since A is nilpotent.
    b = accs / denom
    pv01 = b
    for _ in range(max(plan["depth"], 1)):
        pv01 = b + A(pv01)

    prev_pv01 = torch.where(has_prev, pv01.gather(-1, gather_idx), 0.0)
    dfs = (1.0 - point_rates * prev_pv01) / denom

    lead = dfs.shape[:-1]
    all_times = torch.cat(
        [torch.zeros(times.shape[:-1] + (1,), dtype=times.dtype,
                     device=times.device), times], dim=-1)
    all_dfs = torch.cat(
        [torch.ones(lead + (1,), dtype=dfs.dtype, device=dfs.device), dfs],
        dim=-1)
    return all_times, all_dfs


def bootstrap_pillar_dfs(rates: torch.Tensor, plan: dict) -> torch.Tensor:
    """Pillar-maturity DFs only (used for repricing gates)."""
    _, dfs = bootstrap_ois(rates, plan)
    return dfs[..., plan["pillar_point"] + 1]   # +1 for the t=0 node
