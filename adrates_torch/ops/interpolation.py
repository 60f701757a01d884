"""DF interpolation for the three simple schemes, static and dynamic.

Port of ``adrates_tpu/ops/interpolation.py``: ``simple_interp_plan``
(host numpy, copied verbatim) and ``simple_df_static`` (torch) for the
book path, where both the query times and the grid times are static
(cashflow schedules and bootstrap node times are fixed at trade-compile
time; only the DFs vary), so the plan precomputes the bracketing indices,
the interpolation weight and the exact-knot decision once in numpy and
the differentiated part is gathers plus a handful of elementwise ops;
and ``simple_df`` / ``interp_fit`` / ``interp_df`` for the single-trade
engine, which build the same plan in torch on the device (the same
formulas in the same order, so the two paths agree bit for bit) and
evaluate it with ``simple_df_static``. ``jnp.interp``'s semantics are
kept: the +1e-12 nudge, the clamp outside the grid, the degenerate
interval guard, ``side="right"``, the exact-knot select at 1e-10 on the
un-nudged query and the t = 0 zero-rate patch.

 - FLAT_FWD_RATES      linear in rt = -log(DF)          (piecewise-flat fwd)
 - LINEAR_ZERO_RATES   linear in r = -log(DF)/t
 - LINEAR_FWD_RATES    linear in DF itself

The PCHIP and cubic schemes are not ported yet: they raise ``LibError``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils.error import LibError
from ..utils.global_types import InterpTypes

_SIMPLE_SCHEMES = (InterpTypes.FLAT_FWD_RATES, InterpTypes.LINEAR_ZERO_RATES,
                   InterpTypes.LINEAR_FWD_RATES)

# jnp.interp's degenerate-interval threshold for float64 grids
_DX_EPS = float(np.spacing(np.finfo(np.float64).eps))


def simple_interp_plan(q, x, interp_type: InterpTypes) -> dict:
    """Precompute the static gather/weight plan for STATIC queries ``q``
    and grid times ``x``: dict of numpy arrays consumed by
    :func:`simple_df_static`. Only the three simple schemes."""
    if interp_type not in _SIMPLE_SCHEMES:
        raise LibError("simple_interp_plan: not a simple scheme "
                       + str(interp_type))
    q = np.asarray(q, np.float64)
    x = np.asarray(x, np.float64)
    n = x.shape[0]
    tq = q + 1e-12                      # simple_df's nudge
    i = np.clip(np.searchsorted(x, tq, side="right"), 1, n - 1)
    i0 = (i - 1).astype(np.int64)
    i1 = i.astype(np.int64)
    dx = x[i1] - x[i0]
    delta = tq - x[i0]
    # jnp.interp's degenerate-interval guard, decided statically
    eps = np.spacing(np.finfo(np.float64).eps)
    dx0 = np.abs(dx) <= eps
    c = np.where(dx0, 0.0, delta / np.where(dx0, 1.0, dx))
    lo = tq < x[0]
    hi = tq > x[-1]
    i0[lo] = 0
    i1[lo] = 0
    i0[hi] = n - 1
    i1[hi] = n - 1
    c[lo | hi] = 0.0
    # exact-knot guard on the UN-nudged query (simple_df semantics)
    dist = np.abs(q[:, None] - x[None, :])
    knot_idx = np.argmin(dist, axis=1).astype(np.int64)
    at_knot = dist[np.arange(q.shape[0]), knot_idx] < 1e-10
    plan = dict(i0=i0.astype(np.int32), i1=i1.astype(np.int32), c=c,
                knot_idx=knot_idx.astype(np.int32), at_knot=at_knot,
                q=q)
    if interp_type == InterpTypes.LINEAR_ZERO_RATES:
        # r = -log(d)/x_safe with the t=0 node's rate patched to its
        # neighbour — as a static index remap (r[0] is only ever READ
        # through the gathers below)
        if x[0] == 0.0:
            plan["i0"] = np.where(plan["i0"] == 0, 1,
                                  plan["i0"]).astype(np.int32)
            plan["i1"] = np.where(plan["i1"] == 0, 1,
                                  plan["i1"]).astype(np.int32)
        plan["x_safe"] = np.maximum(x, 1e-15)
    return plan


def plan_to_torch(plan: dict, device) -> dict:
    """A numpy plan (or a stack of them) as tensors on ``device``:
    indices as int64 (what ``torch.gather`` takes), weights f64."""
    out = {}
    for k, v in plan.items():
        v = np.asarray(v)
        if v.dtype == np.bool_:
            out[k] = torch.as_tensor(v, device=device)
        elif np.issubdtype(v.dtype, np.integer):
            out[k] = torch.as_tensor(v.astype(np.int64), device=device)
        else:
            out[k] = torch.as_tensor(v.astype(np.float64), device=device)
    return out


def simple_df_static(plan: dict, dfs: torch.Tensor,
                     interp_type: InterpTypes) -> torch.Tensor:
    """Evaluate a torch plan (:func:`plan_to_torch`) against ``dfs``.

    ``dfs`` is [..., P] and the plan's arrays are [..., Q] with the same
    leading dims (one stacked plan row per curve), so a whole stage of
    curves evaluates in one pass. Returns [..., Q]."""
    d = dfs
    i0, i1, c = plan["i0"], plan["i1"], plan["c"]
    if interp_type == InterpTypes.LINEAR_FWD_RATES:
        y0 = d.gather(-1, i0)
        val = y0 + c * (d.gather(-1, i1) - y0)
    elif interp_type == InterpTypes.FLAT_FWD_RATES:
        rt = -torch.log(d)
        y0 = rt.gather(-1, i0)
        val = torch.exp(-(y0 + c * (rt.gather(-1, i1) - y0)))
    elif interp_type == InterpTypes.LINEAR_ZERO_RATES:
        r = -torch.log(d) / plan["x_safe"]
        y0 = r.gather(-1, i0)
        val = torch.exp(-(y0 + c * (r.gather(-1, i1) - y0)) * plan["q"])
    else:
        raise LibError("not yet ported: interpolation scheme "
                       + str(interp_type))
    return torch.where(plan["at_knot"], d.gather(-1, plan["knot_idx"]), val)


# ---------------------------------------------------------------------------
# Dynamic queries (the single-trade engine)
# ---------------------------------------------------------------------------


class InterpAux(NamedTuple):
    """Per-curve interpolation state from :func:`interp_fit`; empty for
    the simple schemes (the fitted schemes' slopes and spline
    coefficients are not ported yet)."""
    y: Optional[torch.Tensor] = None
    d: Optional[torch.Tensor] = None
    c: Optional[torch.Tensor] = None


def simple_plan_torch(q: torch.Tensor, x: torch.Tensor,
                      interp_type: InterpTypes) -> dict:
    """:func:`simple_interp_plan` built in torch on the tensors' device:
    the same bracket, weight, clamp and knot decisions from the same
    formulas in the same order, for query times ``q`` [Q] on the sorted
    grid ``x`` [N]. Neither is differentiated (only the DFs are)."""
    if interp_type not in _SIMPLE_SCHEMES:
        raise LibError("not yet ported: interpolation scheme "
                       + str(interp_type))
    n = x.shape[0]
    tq = q + 1e-12                      # simple_df's nudge
    i = torch.searchsorted(x, tq, right=True).clamp(1, n - 1)
    i0, i1 = i - 1, i
    dx = x[i1] - x[i0]
    delta = tq - x[i0]
    dx0 = dx.abs() <= _DX_EPS
    c = torch.where(dx0, 0.0, delta / torch.where(dx0, 1.0, dx))
    lo = tq < x[0]
    out = lo | (tq > x[-1])
    edge = torch.where(lo, 0, n - 1)
    i0 = torch.where(out, edge, i0)
    i1 = torch.where(out, edge, i1)
    c = torch.where(out, 0.0, c)
    # exact-knot guard on the UN-nudged query; argmin keeps the first of
    # equal distances, as numpy's does on a grid with a repeated time
    dist = (q[:, None] - x[None, :]).abs()
    knot_idx = dist.argmin(dim=1)
    at_knot = dist.gather(1, knot_idx[:, None])[:, 0] < 1e-10
    plan = dict(i0=i0, i1=i1, c=c, knot_idx=knot_idx, at_knot=at_knot, q=q)
    if interp_type == InterpTypes.LINEAR_ZERO_RATES:
        # the t = 0 node's zero rate patched to its neighbour's, as an
        # index remap (the rate at node 0 is only read through the
        # brackets)
        zero0 = x[0] == 0.0
        plan["i0"] = torch.where(zero0 & (i0 == 0), 1, i0)
        plan["i1"] = torch.where(zero0 & (i1 == 0), 1, i1)
        plan["x_safe"] = x.clamp(min=1e-15)
    return plan


def simple_df(t, times: torch.Tensor, dfs: torch.Tensor,
              interp_type: InterpTypes) -> torch.Tensor:
    """DF(t) for the three simple schemes on the grid (``times``,
    ``dfs``), vectorized over ``t`` (a 0-d ``t`` gives a 0-d result).
    Differentiable in ``dfs`` to every order."""
    t = torch.as_tensor(t, dtype=torch.float64, device=dfs.device)
    tt = t.reshape(-1)
    out = simple_df_static(simple_plan_torch(tt, times, interp_type), dfs,
                           interp_type)
    return out.reshape(t.shape)


def interp_fit(times: torch.Tensor, dfs: torch.Tensor,
               interp_type: InterpTypes) -> InterpAux:
    """Scheme-specific state for a curve: nothing for the simple schemes;
    the PCHIP and cubic fits are not ported yet."""
    if times.shape[0] == 1 or interp_type in _SIMPLE_SCHEMES:
        return InterpAux()
    raise LibError("not yet ported: interpolation scheme "
                   + str(interp_type))


def interp_df(t, times: torch.Tensor, dfs: torch.Tensor,
              interp_type: InterpTypes, aux: InterpAux = None
              ) -> torch.Tensor:
    """DF(t) under a curve's scheme (``aux`` from :func:`interp_fit`).
    Only the simple schemes are ported; the others raise ``LibError``
    (from :func:`simple_plan_torch`)."""
    return simple_df(t, times, dfs, interp_type)
