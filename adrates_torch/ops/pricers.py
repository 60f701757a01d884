"""Compiled leg containers and the leg pricers (port of
``adrates_tpu/ops/pricers.py``).

The containers are plain dataclasses of host numpy arrays, filled by the
legs' ``tensor()`` at trade-compile time and consumed by the book
compilers and the single-trade engine; :func:`leg_to_torch` gives their
device form. :func:`pv_float_leg` prices a float leg through static
interpolation plans (the batched XCCY calibration legs) or, given the
curves' grid times, through dynamic interpolation (the engine);
:func:`pv_fixed_leg` prices a fixed leg through dynamic interpolation.
Both take every interpolation scheme: the dynamic paths fit the fitted
schemes on the grid they are given.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.error import LibError
from ..utils.global_types import InterpTypes
from .interpolation import df_static, interp_df


@dataclasses.dataclass(frozen=True)
class FixedLegTensor:
    """Compiled fixed leg: static arrays, one row per payment."""
    payment_times: np.ndarray    # [P] payment time (years from value date)
    payments: np.ndarray         # [P] coupon amounts (alpha * N * c)
    principal: np.ndarray        # scalar principal amount paid at maturity
    leg_sign: np.ndarray         # +1 receive / -1 pay
    value_time: np.ndarray       # scalar time of the valuation date


@dataclasses.dataclass(frozen=True)
class FloatLegTensor:
    """Compiled floating leg."""
    payment_times: np.ndarray    # [P]
    start_times: np.ndarray      # [P] accrual start (projection curve time)
    end_times: np.ndarray        # [P] accrual end
    pay_alphas: np.ndarray       # [P] payment-basis accrual fractions
    index_alphas: np.ndarray     # [P] accrual fractions in the INDEX
    #   curve's day count — the forward divisor. The reference projects
    #   forwards as (df_s/df_e - 1) / yearfrac(index curve dc)
    #   (swap_float_leg.py:229-233, frn.py:139-146) while coupons accrue
    #   on the leg's own basis; when the two day counts differ the alphas
    #   no longer cancel.
    spreads: np.ndarray          # [P]
    notionals: np.ndarray        # [P]
    principal: np.ndarray        # scalar
    leg_sign: np.ndarray         # +1 / -1
    value_time: np.ndarray       # scalar
    first_fixing_rate: np.ndarray    # scalar (0 when unused)
    notional_exchange_amount: np.ndarray  # scalar (0 when unused)
    effective_time: np.ndarray       # scalar
    maturity_time: np.ndarray        # scalar
    cap_rate: np.ndarray             # scalar, +inf when unused
    floor_rate: np.ndarray           # scalar, -inf when unused
    override_first: bool = False
    notional_exchange: bool = False
    has_cap_floor: bool = False


_LEG_FLAGS = ("override_first", "notional_exchange", "has_cap_floor")


def leg_to_torch(leg, device) -> dict:
    """A (possibly stacked) FloatLegTensor or FixedLegTensor as a dict of
    f64 tensors on ``device``; the float leg's three static switches stay
    Python bools."""
    out = {}
    for f in dataclasses.fields(leg):
        v = getattr(leg, f.name)
        out[f.name] = bool(v) if f.name in _LEG_FLAGS else torch.as_tensor(
            np.asarray(v, dtype=np.float64), device=device)
    return out


def pv_fixed_leg(dfs: torch.Tensor, times: torch.Tensor,
                 interp_type: InterpTypes, leg: dict) -> torch.Tensor:
    """PV of a fixed leg on the discount grid (``times``, ``dfs``):
    future-payment mask, DFs relative to the valuation time, the
    principal on the final flow, the leg sign. ``leg`` is the
    :func:`leg_to_torch` form of one FixedLegTensor. Returns a 0-d
    tensor."""
    pay_t = leg["payment_times"]
    n = pay_t.shape[0]
    qt = torch.cat([pay_t, leg["value_time"].reshape(1)])
    df_all = interp_df(qt, times, dfs, interp_type)
    df_pmts = df_all[:n]
    df_val = df_all[n]

    mask = pay_t > leg["value_time"]
    last = torch.arange(n, device=pay_t.device) == n - 1
    amounts = leg["payments"] + torch.where(last, leg["principal"], 0.0)
    pv = torch.where(mask, (leg["leg_sign"] * amounts) * (df_pmts / df_val),
                     0.0)
    return pv.sum()


def pv_float_leg(dfs: torch.Tensor, disc_interp_type: InterpTypes,
                 leg: dict, plans: dict = None, idx_dfs: torch.Tensor = None,
                 idx_interp_type: InterpTypes = None, *,
                 times: torch.Tensor = None,
                 idx_times: torch.Tensor = None) -> torch.Tensor:
    """PV of a floating leg: forwards projected off the index curve,
    discounted on the discount curve (engine parity: dual-curve support,
    0-accrual guard, first-fixing override on flow 0, strictly-future
    coupon mask, optional principal and notional exchanges).

    ``leg`` is a :func:`leg_to_torch` dict whose arrays are [..., P]
    (scalars [...]). The DFs at the query orders concat(start, end) and
    concat(pay, value[, effective, maturity]) come from ``plans``,
    dict(idx=..., disc=...) of torch static plans (``df_static``: stacked
    simple plans with the same leading dims as ``dfs``, or stacked
    fitted member plans over ``dfs``'s first axis), or dict(both=...,
    n_idx=...) when one fitted curve is both (its plan's queries the
    index ones, ``n_idx`` of them, then the discount ones: one
    ``ops/fitted_rows`` call), or, without plans, from
    dynamic
    interpolation of one leg on the grids (``times``, ``dfs``) and
    (``idx_times``, ``idx_dfs``), each defaulting to the discount curve's.
    Returns [...]."""
    if plans is None and times is None:
        raise LibError("pv_float_leg needs static interpolation plans or "
                       "the curves' grid times")
    idx_dfs = dfs if idx_dfs is None else idx_dfs
    idx_it = disc_interp_type if idx_interp_type is None \
        else idx_interp_type
    pay_t = leg["payment_times"]
    n = pay_t.shape[-1]

    if plans is not None and "both" in plans:
        if idx_dfs is not dfs or idx_it != disc_interp_type:
            raise LibError("pv_float_leg: a joint plan needs one curve")
        both = df_static(plans["both"], dfs, disc_interp_type)
        idx_out = both[..., :plans["n_idx"]]
        disc_out = both[..., plans["n_idx"]:]
    elif plans is not None:
        idx_out = df_static(plans["idx"], idx_dfs, idx_it)
        disc_out = df_static(plans["disc"], dfs, disc_interp_type)
    else:
        # one batched query per curve
        idx_times = times if idx_times is None else idx_times
        idx_q = torch.cat([leg["start_times"], leg["end_times"]])
        idx_out = interp_df(idx_q, idx_times, idx_dfs, idx_it)
        extra = [leg["value_time"].reshape(1)]
        if leg["notional_exchange"]:
            extra += [leg["effective_time"].reshape(1),
                      leg["maturity_time"].reshape(1)]
        disc_out = interp_df(torch.cat([pay_t] + extra), times, dfs,
                             disc_interp_type)
    df_start = idx_out[..., :n]
    df_end = idx_out[..., n:]
    df_pmts = disc_out[..., :n]
    df_val = disc_out[..., n:n + 1]

    # double-where guard: the unselected branch must not divide by the
    # padded ia=0 slots — its VJP otherwise computes Inf * 0 = NaN, which
    # surfaces the moment the curve grid becomes a differentiation INPUT
    # (structured_risk feeds parent grids as explicit stage inputs; the
    # NaN landed on the t=0 node's cotangent and poisoned every gamma).
    has_accrual = leg["index_alphas"] > 0
    ia_safe = torch.where(has_accrual, leg["index_alphas"], 1.0)
    fwd = torch.where(has_accrual,
                      (df_start / df_end - 1.0) / ia_safe, 0.0)

    pos = torch.arange(n, device=pay_t.device)
    if leg["override_first"]:
        fwd = torch.where(pos == 0, leg["first_fixing_rate"][..., None],
                          fwd)

    # Cap/floor clamps the ALL-IN rate (fwd + margin), FRN convention.
    rate = fwd + leg["spreads"]
    if leg["has_cap_floor"]:
        rate = torch.clamp(rate, leg["floor_rate"][..., None],
                           leg["cap_rate"][..., None])

    # Principal rides on the final payment row.
    cf_amounts = rate * leg["pay_alphas"] * leg["notionals"] \
        + torch.where(pos == n - 1, leg["principal"][..., None], 0.0)

    # Strictly-future coupons only (a coupon on the valuation date has
    # settled), matching the fixed-leg mask and SwapFloatLeg.value().
    sign = leg["leg_sign"][..., None]
    valid = pay_t > leg["value_time"][..., None]
    pv = torch.where(valid, (sign * cf_amounts) * (df_pmts / df_val), 0.0)
    total = pv.sum(dim=-1)

    if leg["notional_exchange"]:
        ex_dfs = disc_out[..., n + 1:n + 3]
        ex_times = torch.stack([leg["effective_time"],
                                leg["maturity_time"]], dim=-1)
        amt = leg["notional_exchange_amount"]
        ex_amounts = torch.stack([-amt, amt], dim=-1)
        ex_pv = torch.where(ex_times >= leg["value_time"][..., None],
                            (sign * ex_amounts) * (ex_dfs / df_val), 0.0)
        total = total + ex_pv.sum(dim=-1)
    return total
