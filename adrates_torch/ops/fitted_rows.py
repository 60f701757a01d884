"""The fitted schemes' curve rows at static queries on K6 / K7.

On a static plan (``ops/interpolation.fitted_interp_plan``: the knots,
the queries and their brackets fixed when the book compiles) every fitted
scheme is, past an elementwise transform of the DFs, a linear map: a
cubic Hermite interpolant at static brackets with static weights, on
slopes that are given (the PCHIP schemes) or are the spline's T^-1 R y
(the three spline schemes; T and R depend on the knots alone). A stage's
fitted members, stacked (:class:`FittedPlan`: the schemes and the
transforms' tables around ``kernels.FittedTables``), are evaluated from
DFs to DFs by :func:`fitted_eval`: one ``torch.autograd.Function``
(``_FittedEval``) whose forward is one K6 ``fitted_eval`` launch (the pad
mask, the log DF or the zero rate with the t = 0 node patched to its
neighbour, the PCHIP slopes or the spline solve, the Hermite rows and
exp(u) or exp(-t u), ``csrc/fitted_rows.cu``), whose ``jvp`` is one launch
of its tangent mode (``_FittedTangent``, K6 ``fitted_eval_jvp``: a block
of tangent directions a primal row, the primal transforms taken once),
whose ``vmap`` folds every batch dimension into the rows (and a tangent
batched over an unbatched primal into that primal's directions), and
whose ``backward`` is the vjp of the composition, recomputed from the
saved DFs: the transforms' vjp by torch ops around the linear map's
transpose on K7 ``fitted_rows_t`` (``_FittedRows``, whose own backward and
jvp are K6's linear entry ``fitted_rows`` and K7). So every derivative at
every order is a launch of one of the kernels or torch ops around K7, as
the pv01 solves of ``ops/linear_solve`` are.

The plain versions (:func:`fitted_eval_plain`, the composition: torch
transforms around ``kernels.fitted_rows_plain``, and
:func:`fitted_eval_jvp_plain`, its directional derivative) run where the
DFs lie on the CPU.

Forward mode: at most ONE level, as for the solves: an outer forward
level does not record a Function's ``jvp`` rule, so ``jvp`` over ``jvp``
would drop the cross terms of exp(L log df) and return a wrong number.
The Functions raise :class:`LibError` there instead
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
    members stacked): K6 / K7's ``tables``, K6's transform tables (``fx``,
    ``fmode``, ``fac``) and the plain composition's masks around them
    (:func:`fitted_eval_plain`). ``stacked`` says whether the DFs carry
    the member axis (a list of plans) or not (one plan); ``qshape`` is the
    members' common query shape (None where it differs)."""
    tables: kernels.FittedTables
    schemes: tuple
    stacked: bool
    qshape: object
    zr: torch.Tensor          # [G, 1] bool: a zero-rate member
    any_zr: bool
    all_zr: bool
    patch: object             # [G, n_max] int64 gather (t = 0 patch) or None
    pad: object               # [G, n_max] bool pad knots, or None
    fac: torch.Tensor         # [G, W_max] -q (zero rates), 1 (log), 0 (pad)
    fx: torch.Tensor          # [G, 5, n_max] -(x + gSmall), h, w1, w2, w12
    fmode: torch.Tensor       # [G] int32: 1 zero rates, | 2 t = 0 patched
    dsel: object              # [G, 2 n_max] int64: [y | d] from [y, m, int]

    @property
    def G(self) -> int:
        return self.tables.G

    # views of fx: the interval lengths h [G, n_max - 1] (pads 1) and the
    # PCHIP weights w1 = 2 h1 + h0, w2 = h1 + 2 h0, w12 = w1 + w2
    # [G, n_max - 2]
    @property
    def negxg(self) -> torch.Tensor:
        return self.fx[:, FX_NEGXG]

    @property
    def h(self) -> torch.Tensor:
        return self.fx[:, FX_H, :-1]

    @property
    def w1(self) -> torch.Tensor:
        return self.fx[:, FX_W1, :-2]

    @property
    def w2(self) -> torch.Tensor:
        return self.fx[:, FX_W2, :-2]

    @property
    def w12(self) -> torch.Tensor:
        return self.fx[:, FX_W12, :-2]

    def check(self, schemes) -> None:
        """Raise unless the members' schemes are ``schemes``."""
        if tuple(schemes) != self.schemes:
            raise ValueError(f"fitted plans of {self.schemes} evaluated "
                             f"as {tuple(schemes)}")


# the rows of FittedPlan.fx (csrc/fitted_rows.cu kNegX .. kW12)
FX_NEGXG, FX_H, FX_W1, FX_W2, FX_W12 = range(5)
# FittedPlan.fmode's bits (csrc/fitted_rows.cu kZeroRates, kPatch)
FM_ZERO_RATES, FM_PATCH = 1, 2


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
    patched = zr & (x[:, 0] == 0.0)
    patch = np.tile(np.arange(n_max), (G, 1))
    patch[patched, 0] = 1
    pad = np.arange(n_max)[None, :] >= np.asarray(ns)[:, None]
    fac = np.where(zr[:, None], -q, 1.0)
    fac[~qmask] = 0.0
    fx = np.zeros((G, 5, n_max))
    fx[:, FX_NEGXG] = -(x + gSmall)
    h = x[:, 1:] - x[:, :-1]
    fx[:, FX_H, :-1] = h
    h0, h1 = h[:, :-1], h[:, 1:]
    fx[:, FX_W1, :-2] = 2.0 * h1 + h0
    fx[:, FX_W2, :-2] = h1 + 2.0 * h0
    fx[:, FX_W12, :-2] = fx[:, FX_W1, :-2] + fx[:, FX_W2, :-2]
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
        all_zr=bool(zr.all()),
        patch=t(patch, np.int64) if bool(patched.any()) else None,
        pad=t(pad, bool) if bool(pad.any()) else None, fac=t(fac),
        fx=t(fx), fmode=t(zr * FM_ZERO_RATES + patched * FM_PATCH,
                          np.int32),
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


def _transformed(tab: FittedPlan, dfs: torch.Tensor):
    """(d, y): the DFs at the knots (pads 1) and their transformed values,
    the log DF or the zero rate -log(df) / (t + gSmall) with the t = 0
    knot patched to its neighbour."""
    d = dfs[..., :tab.tables.n_max]
    if tab.pad is not None:
        d = torch.where(tab.pad, 1.0, d)
    y = torch.log(d)
    if tab.any_zr:
        z = y / tab.negxg
        y = z if tab.all_zr else torch.where(tab.zr, z, y)
        if tab.patch is not None:
            y = y.gather(-1, tab.patch.expand(y.shape))
    return d, y


def _secants(tab: FittedPlan, y: torch.Tensor):
    """PCHIP's (m, cond, safe_m0, safe_m1, den): the secants, the guard
    m0 m1 > 0 of each interior knot, the secants with 1 where it is false,
    and the weighted harmonic mean's denominator."""
    m = (y[..., 1:] - y[..., :-1]) / tab.h
    m0 = m[..., :-1]
    m1 = m[..., 1:]
    cond = (m0 * m1) > 0
    safe_m0 = torch.where(cond, m0, 1.0)
    safe_m1 = torch.where(cond, m1, 1.0)
    return m, cond, safe_m0, safe_m1, tab.w1 / safe_m0 + tab.w2 / safe_m1


def _select(tab: FittedPlan, y, m, interior) -> torch.Tensor:
    """[y | d] [..., G, 2, n_max] from the knot values, the secants and
    the interior slopes: each member's first knot takes its first
    secant, its last knot its last, pads the first."""
    both = torch.cat([y, m, interior], dim=-1)
    X = both.gather(-1, tab.dsel.expand(both.shape[:-1]
                                        + tab.dsel.shape[-1:]))
    return X.unflatten(-1, (2, tab.tables.n_max))


def _knots(tab: FittedPlan, dfs: torch.Tensor) -> torch.Tensor:
    """X [..., G, K, n_max], the linear map's input, from the DFs
    [..., G, L]: the transformed knot values and, where K is 2, the PCHIP
    slopes beside them (``interpolation.pchip_slopes``' arithmetic on the
    stacked rows)."""
    _, y = _transformed(tab, dfs)
    if tab.tables.K == 1:
        return y.unsqueeze(-2)
    m, cond, _, _, den = _secants(tab, y)
    return _select(tab, y, m, torch.where(cond, tab.w12 / den, 0.0))


def _knots_jvp(tab: FittedPlan, dfs: torch.Tensor,
               ddfs: torch.Tensor) -> torch.Tensor:
    """dX [..., G, K, n_max]: :func:`_knots`' directional derivative at
    ``dfs`` along ``ddfs`` (the shapes broadcast), written out: the
    transforms' tangents, and PCHIP's slope derivative, exactly 0 where
    the guard is false."""
    d, y = _transformed(tab, dfs)
    dd = ddfs[..., :tab.tables.n_max]
    if tab.pad is not None:
        dd = torch.where(tab.pad, 0.0, dd)
    dy = dd / d
    if tab.any_zr:
        dz = dy / tab.negxg
        dy = dz if tab.all_zr else torch.where(tab.zr, dz, dy)
        if tab.patch is not None:
            dy = dy.gather(-1, tab.patch.expand(dy.shape))
    if tab.tables.K == 1:
        return dy.unsqueeze(-2)
    _, cond, sm0, sm1, den = _secants(tab, y)
    dm = (dy[..., 1:] - dy[..., :-1]) / tab.h
    a, b = tab.w1 / sm0, tab.w2 / sm1
    dden = -(a * (torch.where(cond, dm[..., :-1], 0.0) / sm0)
             + b * (torch.where(cond, dm[..., 1:], 0.0) / sm1))
    dint = torch.where(cond, -(tab.w12 / den) * (dden / den), 0.0)
    return _select(tab, dy, dm, dint)


def _knots_vjp(tab: FittedPlan, dfs: torch.Tensor,
               gX: torch.Tensor) -> torch.Tensor:
    """d-bar [..., G, L]: :func:`_knots`' vjp at ``dfs`` of the cotangent
    ``gX`` [..., G, K, n_max], written out (0 at pad knots and past
    them)."""
    n = tab.tables.n_max
    d, y = _transformed(tab, dfs)
    if tab.tables.K == 1:
        gy = gX[..., 0, :]
    else:
        _, cond, sm0, sm1, den = _secants(tab, y)
        flat = gX.flatten(-2)
        gboth = flat.new_zeros(flat.shape[:-1] + (3 * n - 3,)).scatter_add(
            -1, tab.dsel.expand(flat.shape), flat)
        gy = gboth[..., :n]
        gm = gboth[..., n:2 * n - 1]
        # interior = w12 / den, den = w1 / sm0 + w2 / sm1
        gden = -torch.where(cond, gboth[..., 2 * n - 1:], 0.0) \
            * (tab.w12 / den) / den
        gm0 = torch.where(cond, -gden * (tab.w1 / sm0) / sm0, 0.0)
        gm1 = torch.where(cond, -gden * (tab.w2 / sm1) / sm1, 0.0)
        zero = gm0.new_zeros(gm0.shape[:-1] + (1,))
        gm = gm + torch.cat([gm0, zero], -1) + torch.cat([zero, gm1], -1)
        gmh = gm / tab.h
        zero = gmh.new_zeros(gmh.shape[:-1] + (1,))
        gy = gy + torch.cat([zero, gmh], -1) - torch.cat([gmh, zero], -1)
    if tab.any_zr:
        if tab.patch is not None:
            gy = gy.new_zeros(gy.shape).scatter_add(
                -1, tab.patch.expand(gy.shape), gy)
        gz = gy / tab.negxg
        gy = gz if tab.all_zr else torch.where(tab.zr, gz, gy)
    gd = gy / d
    if tab.pad is not None:
        gd = torch.where(tab.pad, 0.0, gd)
    return torch.nn.functional.pad(gd, (0, dfs.shape[-1] - n))


def _lin(rows, X: torch.Tensor, tab: kernels.FittedTables) -> torch.Tensor:
    """``rows`` (a K6 linear map: the wrapper or its twin) on X
    [..., G, K, n_max] -> [..., G, W_max]."""
    lead = X.shape[:-3]
    out = rows(X.reshape((-1,) + X.shape[-3:]), tab)
    return out.reshape(lead + out.shape[-2:])


def fitted_eval_plain(tab: FittedPlan, dfs: torch.Tensor,
                      rows=None) -> torch.Tensor:
    """Plain version of K6 ``fitted_eval``: the members' DFs at their
    queries [R, G, W_max] from the DFs [R, G, L] (the first n_g positions
    member g's knots; pad queries 1): the torch transforms around the
    linear map ``rows`` (default ``kernels.fitted_rows_plain``; the
    wrapper's CPU route passes ``kernels.fitted_rows``, whose CPU route
    is that twin), then exp(fac u)."""
    rows = kernels.fitted_rows_plain if rows is None else rows
    return torch.exp(tab.fac * _lin(rows, _knots(tab, dfs), tab.tables))


def _tangent_ops(tab: FittedPlan, dfs, ddfs, out, rows) -> torch.Tensor:
    """dout [..., D, G, W_max] = out (fac L(dX)): the directional
    derivative of the composition at ``dfs`` [..., G, L] (``out`` its
    value [..., G, W_max]) along each of ``ddfs`` [..., D, G, L], dX the
    transforms' jvp (:func:`_knots_jvp`)."""
    dX = _knots_jvp(tab, dfs.unsqueeze(-3), ddfs)
    return out.unsqueeze(-3) * (tab.fac * rows(dX))


def fitted_eval_jvp_plain(tab: FittedPlan, dfs: torch.Tensor,
                          ddfs: torch.Tensor, out: torch.Tensor,
                          rows=None) -> torch.Tensor:
    """Plain version of K6's tangent mode ``fitted_eval_jvp``: dout
    [R, D, G, W_max] from the DFs [R, G, L], D tangent rows a primal row
    ``ddfs`` [R, D, G, L] and the values ``out`` = fitted_eval(dfs)
    [R, G, W_max]: the jvp of :func:`fitted_eval_plain`'s composition
    (its transforms' tangents, the linear map ``rows`` on them, exp's
    chain rule on ``out``)."""
    rows = kernels.fitted_rows_plain if rows is None else rows
    return _tangent_ops(tab, dfs, ddfs, out,
                        lambda X: _lin(rows, X, tab.tables))


class _FittedEval(torch.autograd.Function):
    """The members' DFs at their queries [..., G, W_max] from the DFs
    [..., G, L]: K6 ``fitted_eval``."""

    @staticmethod
    def forward(dfs, tab):
        lead = dfs.shape[:-2]
        out = kernels.fitted_eval(
            dfs.reshape((-1,) + dfs.shape[-2:]).contiguous(), tab)
        return out.reshape(lead + out.shape[-2:])

    @staticmethod
    def setup_context(ctx, inputs, output):
        dfs, tab = inputs
        ctx.save_for_backward(dfs, output)
        ctx.save_for_forward(dfs, output)
        ctx.tab = tab

    @staticmethod
    def backward(ctx, gout):
        # the vjp of exp(fac L X(dfs)): L's transpose on K7, the
        # transforms' vjp from the saved DFs (torch ops, no transform of
        # torch.func: a plan built inside one holds tensors of its levels)
        dfs, out = ctx.saved_tensors
        tab = ctx.tab
        gX = _rows(gout * out * tab.fac, tab.tables, True)
        return _knots_vjp(tab, dfs, gX), None

    @staticmethod
    def jvp(ctx, ddfs, _tab):
        dfs, out = ctx.saved_tensors
        return _tangent(dfs, ddfs.unsqueeze(-3), out, ctx.tab).squeeze(-3)

    @staticmethod
    def vmap(info, in_dims, dfs, tab):
        return fitted_eval(tab, _front(dfs, in_dims[0], info.batch_size)), 0


def _tangent(dfs, ddfs, out, tab: FittedPlan) -> torch.Tensor:
    _one_forward_level("fitted_eval_jvp")
    return _FittedTangent.apply(dfs, ddfs, out, tab)


class _FittedTangent(torch.autograd.Function):
    """dout [..., D, G, W_max]: the directional derivatives of
    :func:`fitted_eval` at the DFs [..., G, L] (``out`` its value
    [..., G, W_max]) along D tangent rows ``ddfs`` [..., D, G, L]: K6
    ``fitted_eval_jvp``. It has no backward: reverse over forward is an
    order the package does not compose, and autograd raises there."""

    @staticmethod
    def forward(dfs, ddfs, out, tab):
        G, L = dfs.shape[-2:]
        lead = dfs.shape[:-2]
        D = ddfs.shape[-3]
        dout = kernels.fitted_eval_jvp(
            dfs.reshape(-1, G, L).contiguous(),
            ddfs.reshape(-1, D, G, L).contiguous(),
            out.reshape((-1,) + out.shape[-2:]).contiguous(), tab)
        return dout.reshape(lead + dout.shape[1:])

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, dfs, ddfs, out, tab):
        bd, bdd, bo = in_dims[:3]
        n = info.batch_size
        if bd is None and bo is None:
            # tangents batched over one primal: the batch joins the
            # primal's directions, the primal is not expanded
            k = ddfs.dim() - 4                  # the directions' axis
            dd = ddfs.movedim(bdd, k).flatten(k, k + 1)
            return _tangent(dfs, dd, out, tab).unflatten(k, (n, -1)), k
        return _tangent(_front(dfs, bd, n), _front(ddfs, bdd, n),
                        _front(out, bo, n), tab), 0


def fitted_eval(tab: FittedPlan, dfs: torch.Tensor) -> torch.Tensor:
    """The members' DFs at their queries, [..., G, W_max], from the DFs
    ``dfs`` [..., G, L] whose first n_g positions are member g's knots
    (positions past them, a stage's padding, are not read). One K6
    launch on a card, and one of its tangent mode under a forward-mode
    level; differentiable to every order with one forward-mode level."""
    _one_forward_level("fitted_eval")
    return _FittedEval.apply(dfs, tab)
