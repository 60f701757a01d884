"""DF interpolation under all eight schemes, static and dynamic.

Port of ``adrates_tpu/ops/interpolation.py``:

 - FLAT_FWD_RATES      linear in rt = -log(DF)          (piecewise-flat fwd)
 - LINEAR_ZERO_RATES   linear in r = -log(DF)/t
 - LINEAR_FWD_RATES    linear in DF itself
 - PCHIP_LOG_DISCOUNT  monotone Hermite on log(DF)
 - PCHIP_ZERO_RATES    monotone Hermite on zero rates
 - NATCUBIC_LOG_DISCOUNT / NATCUBIC_ZERO_RATES  natural cubic spline
 - FINCUBIC_ZERO_RATES clamped spline (S''(t0)=0, S'(tN)=0)

The three simple schemes: ``simple_interp_plan`` (host numpy, copied
verbatim) and ``simple_df_static`` (torch) for the book path, where both
the query times and the grid times are static (cashflow schedules and
bootstrap node times are fixed at trade-compile time; only the DFs vary),
so the plan precomputes the bracketing indices, the interpolation weight
and the exact-knot decision once in numpy and the differentiated part is
gathers plus a handful of elementwise ops; ``simple_df`` for the
single-trade engine, which builds the same plan in torch on the device
(the same formulas in the same order, so the two paths agree bit for
bit). ``jnp.interp``'s semantics are kept: the +1e-12 nudge, the clamp
outside the grid, the degenerate interval guard, ``side="right"``, the
exact-knot select at 1e-10 on the un-nudged query and the t = 0 zero-rate
patch.

The fitted schemes: ``interp_fit`` computes a curve's state (PCHIP slopes,
or spline coefficients from the parallel-cyclic-reduction tridiagonal
solve of ``utils/math.py``), differentiable in the DFs to every order;
``hermite_eval`` / ``cubic_eval`` evaluate it at the bracket
``clip(searchsorted(x, t, left) - 1, 0, n - 2)``, so a query past the last
knot extrapolates the last polynomial and one before the first the first.
``fitted_interp_plan`` fixes that bracket in numpy for static queries on a
static grid (the book path); its device form (``plan_to_torch``) is an
``ops/fitted_rows.FittedPlan``, and ``fitted_df_static`` / ``df_static``
evaluate it through ``ops/fitted_rows`` (the fit and the evaluation as
one linear map on K6, its derivatives on K7 and K6; a list of member
plans stacked into one plan, evaluated in one call). The dynamic
``interp_df`` computes the same bracket with ``torch.searchsorted`` and
fits and evaluates with the torch code here. ``interp_plan`` /
``df_static`` take either kind of plan.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils.error import LibError
from ..utils.global_types import InterpTypes
from ..utils.global_vars import gSmall
from ..utils.math import solve_tridiagonal
from .fitted_rows import FittedPlan, fitted_eval, fitted_plan

_SIMPLE_SCHEMES = (InterpTypes.FLAT_FWD_RATES, InterpTypes.LINEAR_ZERO_RATES,
                   InterpTypes.LINEAR_FWD_RATES)
_PCHIP_SCHEMES = (InterpTypes.PCHIP_LOG_DISCOUNT, InterpTypes.PCHIP_ZERO_RATES)
_CUBIC_SCHEMES = (InterpTypes.FINCUBIC_ZERO_RATES,
                  InterpTypes.NATCUBIC_ZERO_RATES,
                  InterpTypes.NATCUBIC_LOG_DISCOUNT)
_FITTED_SCHEMES = _PCHIP_SCHEMES + _CUBIC_SCHEMES

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


def plan_to_torch(plan, device):
    """A numpy plan (or a stack of them, or a list of per-member plans) on
    ``device``. A simple plan as tensors: indices as int64 (what
    ``torch.gather`` takes), weights and times f64. A fitted plan as its
    ``FittedPlan``, and a list of fitted member plans as one stacked
    ``FittedPlan``."""
    if isinstance(plan, (list, tuple)):
        if plan and all("idx" in p for p in plan):
            return fitted_plan(plan, device, stacked=True)
        return [plan_to_torch(p, device) for p in plan]
    if "idx" in plan:
        return fitted_plan([plan], device, stacked=False)
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
        raise LibError("simple_df_static: not a simple scheme "
                       + str(interp_type))
    return torch.where(plan["at_knot"], d.gather(-1, plan["knot_idx"]), val)


# ---------------------------------------------------------------------------
# The fitted schemes
# ---------------------------------------------------------------------------


class InterpAux(NamedTuple):
    """Per-curve interpolation state from :func:`interp_fit`.

    PCHIP schemes: y = transformed knot values, d = Hermite slopes. Cubic
    schemes: y = transformed knot values, c = [..., 4, N-1] polynomial
    coefficients (highest order first, scipy layout). Empty for the simple
    schemes."""
    y: Optional[torch.Tensor] = None
    d: Optional[torch.Tensor] = None
    c: Optional[torch.Tensor] = None


def _take(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``v`` [..., n] at the last-axis indices ``idx``: a 1-D ``v`` (or a
    1-D ``idx``) is indexed directly, else ``idx`` carries ``v``'s leading
    dims and is gathered."""
    if v.dim() == 1 or idx.dim() == 1:
        return v[..., idx]
    return v.gather(-1, idx)


def _zero_rates(times: torch.Tensor, dfs: torch.Tensor) -> torch.Tensor:
    """Continuously-compounded zero rates with the t=0 node patched to its
    neighbour (parity: interpolator_ad.py:167-170)."""
    zero = -torch.log(dfs) / (times + gSmall)
    first = torch.where(times[..., :1] == 0, zero[..., 1:2], zero[..., :1])
    return torch.cat([first, zero[..., 1:]], dim=-1)


def pchip_slopes(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Shape-preserving Hermite slopes (weighted-harmonic-mean PCHIP):
    endpoint slopes are the one-sided secants; interior slopes are the
    weighted harmonic mean of adjacent secants, zero where the secants
    change sign. Guarded divisions keep every derivative finite."""
    h = x[..., 1:] - x[..., :-1]                 # [n-1]
    m = (y[..., 1:] - y[..., :-1]) / h           # [n-1] secants

    m0 = m[..., :-1]                             # secant left of a node
    m1 = m[..., 1:]                              # secant right of a node
    h0 = h[..., :-1]
    h1 = h[..., 1:]
    cond = (m0 * m1) > 0
    w1 = 2.0 * h1 + h0
    w2 = h1 + 2.0 * h0
    safe_m0 = torch.where(cond, m0, 1.0)
    safe_m1 = torch.where(cond, m1, 1.0)
    interior = torch.where(cond, (w1 + w2) / (w1 / safe_m0 + w2 / safe_m1),
                           0.0)
    return torch.cat([m[..., :1], interior, m[..., -1:]], dim=-1)


def hermite_eval(t: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                 d: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Evaluate the cubic Hermite interpolant at ``t`` on the brackets
    ``idx`` (:func:`fitted_index`)."""
    x0 = _take(x, idx)
    x1 = _take(x, idx + 1)
    y0 = _take(y, idx)
    y1 = _take(y, idx + 1)
    d0 = _take(d, idx)
    d1 = _take(d, idx + 1)
    h = x1 - x0
    s = (t - x0) / h
    s2 = s * s
    s3 = s2 * s
    h00 = 2.0 * s3 - 3.0 * s2 + 1.0
    h10 = s3 - 2.0 * s2 + s
    h01 = -2.0 * s3 + 3.0 * s2
    h11 = s3 - s2
    return h00 * y0 + h10 * h * d0 + h01 * y1 + h11 * h * d1


def cubic_spline_coeffs(x: torch.Tensor, y: torch.Tensor,
                        natural_left: bool = True,
                        clamped_right: bool = False) -> torch.Tensor:
    """Cubic-spline polynomial coefficients, scipy CubicSpline layout.

    Solves the knot-slope tridiagonal system by parallel cyclic reduction
    (``utils/math.solve_tridiagonal``). Boundary conditions: S''(x0) = 0;
    clamped_right: S'(xN) = 0, else natural right (S''(xN) = 0).

    Returns c [..., 4, N-1]: S(t) = c0 u^3 + c1 u^2 + c2 u + c3 on
    [x_i, x_{i+1}], u = t - x_i.
    """
    n = x.shape[-1]
    h = x[..., 1:] - x[..., :-1]                 # [n-1]
    m = (y[..., 1:] - y[..., :-1]) / h           # [..., n-1]

    # Tridiagonal system for the knot slopes s (size n): interior rows
    # enforce C2 continuity, boundary rows encode the BCs.
    inv_h = 1.0 / h
    one = torch.ones(inv_h.shape[:-1] + (1,), dtype=x.dtype,
                     device=x.device)
    lower = torch.cat([0.0 * one, inv_h[..., :-1], one], dim=-1)
    diag = torch.cat([2.0 * one, 2.0 * (inv_h[..., :-1] + inv_h[..., 1:]),
                      2.0 * one], dim=-1)
    upper = torch.cat([one, inv_h[..., 1:], 0.0 * one], dim=-1)
    rhs = torch.cat([3.0 * m[..., :1],
                     3.0 * (m[..., :-1] * inv_h[..., :-1]
                            + m[..., 1:] * inv_h[..., 1:]),
                     3.0 * m[..., -1:]], dim=-1)
    if clamped_right:
        lower = torch.cat([lower[..., :n - 1], 0.0 * one], dim=-1)
        diag = torch.cat([diag[..., :n - 1], one], dim=-1)
        rhs = torch.cat([rhs[..., :n - 1], torch.zeros_like(rhs[..., :1])],
                        dim=-1)

    s = solve_tridiagonal(lower, diag, upper, rhs)

    s0 = s[..., :-1]
    s1 = s[..., 1:]
    c3 = y[..., :-1]
    c2 = s0
    c1 = (3.0 * m - 2.0 * s0 - s1) / h
    c0 = (s0 + s1 - 2.0 * m) / (h * h)
    return torch.stack([c0, c1, c2, c3], dim=-2)


def cubic_eval(t: torch.Tensor, x: torch.Tensor, c: torch.Tensor,
               idx: torch.Tensor) -> torch.Tensor:
    """Evaluate a piecewise cubic with coefficients [..., 4, N-1] at ``t``
    on the brackets ``idx``."""
    u = t - _take(x, idx)
    return ((_take(c[..., 0, :], idx) * u + _take(c[..., 1, :], idx)) * u
            + _take(c[..., 2, :], idx)) * u + _take(c[..., 3, :], idx)


def fitted_index(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The fitted schemes' bracket: clip(searchsorted(x, t, left) - 1, 0,
    n - 2) on the sorted 1-D grid ``x``."""
    return torch.clamp(torch.searchsorted(x, t) - 1, 0, x.shape[-1] - 2)


def _fitted_eval(t, x, aux: InterpAux, idx, interp_type: InterpTypes):
    if interp_type == InterpTypes.PCHIP_LOG_DISCOUNT:
        return torch.exp(hermite_eval(t, x, aux.y, aux.d, idx))
    if interp_type == InterpTypes.PCHIP_ZERO_RATES:
        return torch.exp(-t * hermite_eval(t, x, aux.y, aux.d, idx))
    if interp_type == InterpTypes.NATCUBIC_LOG_DISCOUNT:
        return torch.exp(cubic_eval(t, x, aux.c, idx))
    return torch.exp(-t * cubic_eval(t, x, aux.c, idx))   # zero-rate cubics


def fitted_interp_plan(q, x, interp_type: InterpTypes) -> dict:
    """The static plan of a fitted scheme for STATIC queries ``q`` (any
    shape) on the STATIC sorted grid ``x`` (a curve's real knots): the
    grid, the queries and :func:`fitted_index`'s bracket computed in numpy
    (``searchsorted`` on the left side, as the dynamic path's). Consumed
    by :func:`fitted_df_static`."""
    if interp_type not in _FITTED_SCHEMES:
        raise LibError("fitted_interp_plan: not a fitted scheme "
                       + str(interp_type))
    q = np.asarray(q, np.float64)
    x = np.asarray(x, np.float64)
    idx = np.clip(np.searchsorted(x, q, side="left") - 1, 0,
                  x.shape[0] - 2)
    return dict(x=x, q=q, idx=idx.astype(np.int32),
                scheme=np.array(interp_type.value))


def fitted_df_static(plan: FittedPlan, dfs: torch.Tensor,
                     interp_type: InterpTypes) -> torch.Tensor:
    """Fit the curve on the plan's knots and evaluate it at the plan's
    queries (the device form of one :func:`fitted_interp_plan`), in one
    ``ops/fitted_rows`` call. ``dfs`` [..., L] holds the knots' DFs first
    (positions past the plan's knot count, a stage's padding, are not
    read); leading dims batch. Returns the queries' shape (behind the
    leading dims)."""
    if plan.stacked:
        raise LibError("fitted_df_static takes one curve's plan; a stack "
                       "of member plans goes through df_static")
    plan.check((interp_type,))
    out = fitted_eval(plan, dfs.unsqueeze(-2))[..., 0, :]
    return out.reshape(out.shape[:-1] + plan.qshape)


def _stacked_df(tab: FittedPlan, dfs: torch.Tensor) -> torch.Tensor:
    """Member g of a stacked fitted plan against ``dfs[g]`` ([G, ..., L]):
    [G, ..., *qshape], in one call."""
    if tab.qshape is None:
        raise LibError("df_static: the member plans' queries differ in "
                       "shape")
    out = fitted_eval(tab, dfs.movedim(0, -2))       # [..., G, W]
    out = out.reshape(out.shape[:-1] + tab.qshape)
    return out.movedim(-1 - len(tab.qshape), 0)


def interp_plan(q, x, interp_type: InterpTypes) -> dict:
    """The static plan of any scheme: :func:`simple_interp_plan` or
    :func:`fitted_interp_plan`."""
    if interp_type in _SIMPLE_SCHEMES:
        return simple_interp_plan(q, x, interp_type)
    return fitted_interp_plan(q, x, interp_type)


def df_static(plan, dfs: torch.Tensor,
              interp_type: InterpTypes) -> torch.Tensor:
    """Evaluate a torch static plan of any scheme; a list of per-member
    plans, or a stacked ``FittedPlan``, evaluates member g against
    ``dfs[g]`` and stacks the results (the members of a stage have knot
    counts of their own). A stacked ``FittedPlan`` (``plan_to_torch`` of
    a list of fitted member plans) goes through one ``ops/fitted_rows``
    call however many members it has."""
    if isinstance(plan, (list, tuple)):
        return torch.stack([df_static(p, dfs[g], interp_type)
                            for g, p in enumerate(plan)])
    if isinstance(plan, FittedPlan):
        if not plan.stacked:
            return fitted_df_static(plan, dfs, interp_type)
        plan.check((interp_type,) * plan.G)
        return _stacked_df(plan, dfs)
    return simple_df_static(plan, dfs, interp_type)


# ---------------------------------------------------------------------------
# Dynamic queries (the single-trade engine, the curves' own queries)
# ---------------------------------------------------------------------------


def simple_plan_torch(q: torch.Tensor, x: torch.Tensor,
                      interp_type: InterpTypes) -> dict:
    """:func:`simple_interp_plan` built in torch on the tensors' device:
    the same bracket, weight, clamp and knot decisions from the same
    formulas in the same order, for query times ``q`` [Q] on the sorted
    grid ``x`` [N]. Neither is differentiated (only the DFs are)."""
    if interp_type not in _SIMPLE_SCHEMES:
        raise LibError("simple_plan_torch: not a simple scheme "
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
    """Scheme-specific state for a curve on the grid (``times`` [N],
    ``dfs`` [..., N]): nothing for the simple schemes (or a one-node
    grid), else the transformed knot values and the PCHIP slopes or the
    spline coefficients. Differentiable in ``dfs`` to every order."""
    if times.shape[-1] == 1 or interp_type in _SIMPLE_SCHEMES:
        return InterpAux()
    if interp_type == InterpTypes.PCHIP_LOG_DISCOUNT:
        y = torch.log(dfs)
        return InterpAux(y=y, d=pchip_slopes(times, y))
    if interp_type == InterpTypes.PCHIP_ZERO_RATES:
        y = _zero_rates(times, dfs)
        return InterpAux(y=y, d=pchip_slopes(times, y))
    if interp_type == InterpTypes.NATCUBIC_LOG_DISCOUNT:
        y = torch.log(dfs)
        return InterpAux(y=y, c=cubic_spline_coeffs(times, y))
    if interp_type == InterpTypes.NATCUBIC_ZERO_RATES:
        y = _zero_rates(times, dfs)
        return InterpAux(y=y, c=cubic_spline_coeffs(times, y))
    if interp_type == InterpTypes.FINCUBIC_ZERO_RATES:
        y = _zero_rates(times, dfs)
        return InterpAux(y=y, c=cubic_spline_coeffs(times, y,
                                                    clamped_right=True))
    raise LibError("Invalid interpolation scheme " + str(interp_type))


def interp_df(t, times: torch.Tensor, dfs: torch.Tensor,
              interp_type: InterpTypes, aux: InterpAux = None
              ) -> torch.Tensor:
    """DF(t) under a curve's scheme on the grid (``times``, ``dfs``),
    vectorized over ``t`` (a 0-d ``t`` gives a 0-d result). ``aux`` from
    :func:`interp_fit` (the fitted schemes refit without it).
    Differentiable in ``dfs`` to every order."""
    if interp_type in _SIMPLE_SCHEMES:
        return simple_df(t, times, dfs, interp_type)
    t = torch.as_tensor(t, dtype=torch.float64, device=dfs.device)
    tt = t.reshape(-1)
    if aux is None or (aux.d is None and aux.c is None):
        aux = interp_fit(times, dfs, interp_type)
    out = _fitted_eval(tt, times, aux, fitted_index(tt, times), interp_type)
    return out.reshape(out.shape[:-1] + t.shape)
