"""The fitted schemes' curve rows at static queries on K6 / K7.

On a static plan (``ops/interpolation.fitted_interp_plan``: the knots,
the queries and their brackets fixed when the book compiles) every fitted
scheme is, past an elementwise transform of the DFs, a linear map: a
cubic Hermite interpolant at static brackets with static weights, on
slopes that are given (the PCHIP schemes) or are the spline's T^-1 R y
(the three spline schemes; T and R depend on the knots alone). The map,
for a stage's fitted members stacked (:class:`FittedPlan`: the schemes
and the transforms' tensors around ``kernels.FittedTables``), runs on
K6 ``fitted_rows`` and its transpose on K7 ``fitted_rows_t``
(``csrc/fitted_rows.cu``), behind one ``torch.autograd.Function``: its
``backward`` is the transpose (K7 for the map, K6 for the transpose),
its ``jvp`` the map itself on the tangents, and ``vmap`` folds every
batch dimension into the rows. So every derivative at every order is one
more launch of one of the two, as the pv01 solves of ``ops/linear_solve``
are.

Around it stay torch ops, applied to the stacked tensor with static
per-member masks (:func:`fitted_eval`): the log DF or the zero rate (with
the t = 0 node patched to its neighbour), the PCHIP slopes, and
exp(u) or exp(-t u).

Forward mode: at most ONE level, as for the solves: an outer forward
level does not record a Function's ``jvp`` rule, so ``jvp`` over ``jvp``
would drop the cross terms of exp(L log df) and return a wrong number.
The Function raises :class:`LibError` there instead
(``linear_solve._one_forward_level``); compose
``jacfwd(jacrev(jacrev(f)))``, or ``linear_solve.jvp_by_vjp`` inside a
``jvp``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..utils.global_types import InterpTypes
from ..utils.global_vars import gSmall
from . import kernels
from .linear_solve import _front, _one_forward_level

_KIND = {InterpTypes.PCHIP_LOG_DISCOUNT: kernels.FIT_HERMITE,
         InterpTypes.PCHIP_ZERO_RATES: kernels.FIT_HERMITE,
         InterpTypes.NATCUBIC_LOG_DISCOUNT: kernels.FIT_NATURAL,
         InterpTypes.NATCUBIC_ZERO_RATES: kernels.FIT_NATURAL,
         InterpTypes.FINCUBIC_ZERO_RATES: kernels.FIT_CLAMPED}
_ZERO_RATES = (InterpTypes.PCHIP_ZERO_RATES, InterpTypes.NATCUBIC_ZERO_RATES,
               InterpTypes.FINCUBIC_ZERO_RATES)


@dataclasses.dataclass(frozen=True, eq=False)
class FittedPlan:
    """The device form of static fitted plans (one curve's, or a stage's
    members stacked): K6 / K7's ``tables`` and the tensors of the torch
    transforms around them (:func:`fitted_eval`). ``stacked`` says
    whether the DFs carry the member axis (a list of plans) or not (one
    plan); ``qshape`` is the members' common query shape (None where it
    differs)."""
    tables: kernels.FittedTables
    schemes: tuple
    stacked: bool
    qshape: object
    zr: torch.Tensor          # [G, 1] bool: a zero-rate member
    any_zr: bool
    all_zr: bool
    negxg: torch.Tensor       # [G, n_max] -(x + gSmall)
    patch: object             # [G, n_max] int64 gather (t = 0 patch) or None
    pad: object               # [G, n_max] bool pad knots, or None
    fac: torch.Tensor         # [G, W_max] -q (zero rates), 1 (log), 0 (pad)
    h: torch.Tensor           # [G, n_max - 1] interval lengths (pads 1)
    w1: torch.Tensor          # [G, n_max - 2] PCHIP weights 2 h1 + h0
    w2: torch.Tensor          # [G, n_max - 2] h1 + 2 h0
    w12: torch.Tensor         # [G, n_max - 2] w1 + w2
    dsel: object              # [G, 2 n_max] int64: [y | d] from [y, m, int]

    @property
    def G(self) -> int:
        return self.tables.G

    def check(self, schemes) -> None:
        """Raise unless the members' schemes are ``schemes``."""
        if tuple(schemes) != self.schemes:
            raise ValueError(f"fitted plans of {self.schemes} evaluated "
                             f"as {tuple(schemes)}")


def fitted_plan(plans: Sequence[dict], device,
                stacked: bool = True) -> FittedPlan:
    """The :class:`FittedPlan` on ``device`` of host fitted plans
    (``ops/interpolation.fitted_interp_plan``: ``x``, ``q``, ``idx``,
    ``scheme``), one member a plan. ``stacked=False`` (one plan) reads
    DFs without a member axis."""
    plans = tuple(plans)
    schemes = tuple(InterpTypes(int(np.asarray(p["scheme"]))) for p in plans)
    tab = kernels.fitted_tables([(p["x"], p["q"], p["idx"], _KIND[s])
                                 for p, s in zip(plans, schemes)], device)
    host = tab.host
    x, q, qmask, ns = host["x"], host["q"], host["qmask"], host["ns"]
    G, n_max = x.shape
    qs = [np.shape(p["q"]) for p in plans]
    zr = np.array([s in _ZERO_RATES for s in schemes])
    patch = np.tile(np.arange(n_max), (G, 1))
    patch[zr & (x[:, 0] == 0.0), 0] = 1
    pad = np.arange(n_max)[None, :] >= np.asarray(ns)[:, None]
    fac = np.where(zr[:, None], -q, 1.0)
    fac[~qmask] = 0.0
    h = x[:, 1:] - x[:, :-1]
    h0, h1 = h[:, :-1], h[:, 1:]
    w1 = 2.0 * h1 + h0
    w2 = h1 + 2.0 * h0
    dsel = None
    if tab.K == 2:
        # the slope of knot i: m_0 at i = 0, m_{n-2} at the last knot,
        # the interior formula between, m_0 in the pads
        sl = np.full((G, n_max), n_max, np.int64)
        for g in range(G):
            n = ns[g]
            sl[g, 1:n - 1] = 2 * n_max - 1 + np.arange(n - 2)
            sl[g, n - 1] = n_max + n - 2
        dsel = np.concatenate([np.tile(np.arange(n_max), (G, 1)), sl], 1)

    def t(a, dtype=np.float64):
        return torch.as_tensor(np.ascontiguousarray(a, dtype), device=device)

    return FittedPlan(
        tables=tab, schemes=schemes, stacked=stacked,
        qshape=qs[0] if all(s == qs[0] for s in qs) else None,
        zr=t(zr[:, None], bool), any_zr=bool(zr.any()),
        all_zr=bool(zr.all()), negxg=t(-(x + gSmall)),
        patch=t(patch, np.int64) if bool((patch[:, 0] != 0).any()) else None,
        pad=t(pad, bool) if bool(pad.any()) else None, fac=t(fac), h=t(h),
        w1=t(w1), w2=t(w2), w12=t(w1 + w2),
        dsel=None if dsel is None else t(dsel, np.int64))


def _rows(X: torch.Tensor, tab: kernels.FittedTables,
          transpose: bool) -> torch.Tensor:
    _one_forward_level("fitted_rows_t" if transpose else "fitted_rows")
    return _FittedRows.apply(X, tab, transpose)


class _FittedRows(torch.autograd.Function):
    """U = L X for X [..., G, K, n_max] (U [..., G, W_max]), or with
    ``transpose`` X-bar = L^T U-bar, L the linear map of ``tab``."""

    @staticmethod
    def forward(X, tab, transpose):
        if transpose:
            lead = X.shape[:-2]
            out = kernels.fitted_rows_t(
                X.reshape((-1, tab.G, tab.W_max)).contiguous(), tab)
            return out.reshape(lead + (tab.G, tab.K, tab.n_max))
        lead = X.shape[:-3]
        out = kernels.fitted_rows(
            X.reshape((-1, tab.G, tab.K, tab.n_max)).contiguous(), tab)
        return out.reshape(lead + (tab.G, tab.W_max))

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, tab, transpose = inputs
        ctx.tab = tab
        ctx.transpose = transpose

    @staticmethod
    def backward(ctx, gout):
        return _rows(gout, ctx.tab, not ctx.transpose), None, None

    @staticmethod
    def jvp(ctx, dX, _tab, _transpose):
        return _rows(dX, ctx.tab, ctx.transpose)

    @staticmethod
    def vmap(info, in_dims, X, tab, transpose):
        return _rows(_front(X, in_dims[0], info.batch_size), tab,
                     transpose), 0


def _with_slopes(y: torch.Tensor, tab: FittedPlan):
    """[y | d] [..., G, 2, n_max]: the knot values and their PCHIP slopes
    (``interpolation.pchip_slopes``' arithmetic on the stacked rows; each
    member's last knot takes its own last secant, pads the first)."""
    m = (y[..., 1:] - y[..., :-1]) / tab.h
    m0 = m[..., :-1]
    m1 = m[..., 1:]
    cond = (m0 * m1) > 0
    safe_m0 = torch.where(cond, m0, 1.0)
    safe_m1 = torch.where(cond, m1, 1.0)
    interior = torch.where(cond, tab.w12 / (tab.w1 / safe_m0
                                            + tab.w2 / safe_m1), 0.0)
    both = torch.cat([y, m, interior], dim=-1)
    X = both.gather(-1, tab.dsel.expand(both.shape[:-1]
                                        + tab.dsel.shape[-1:]))
    return X.unflatten(-1, (2, tab.tables.n_max))


def fitted_eval(tab: FittedPlan, dfs: torch.Tensor) -> torch.Tensor:
    """The members' DFs at their queries, [..., G, W_max], from the DFs
    ``dfs`` [..., G, L] whose first n_g positions are member g's knots
    (positions past them, a stage's padding, are not read). One K6
    launch on a card; differentiable to every order with one
    forward-mode level."""
    d = dfs[..., :tab.tables.n_max]
    if tab.pad is not None:
        d = torch.where(tab.pad, 1.0, d)
    y = torch.log(d)
    if tab.any_zr:
        # the zero rate -log(df) / (t + gSmall), t = 0 patched
        z = y / tab.negxg
        y = z if tab.all_zr else torch.where(tab.zr, z, y)
        if tab.patch is not None:
            y = y.gather(-1, tab.patch.expand(y.shape))
    X = _with_slopes(y, tab) if tab.tables.K == 2 else y.unsqueeze(-2)
    return torch.exp(tab.fac * _rows(X, tab.tables, False))
