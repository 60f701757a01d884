"""XCCY multi-curve risk: deltas and gammas against the domestic OIS, the
foreign OIS and the basis spreads, plus the foreign x basis cross-gamma.

Port of ``adrates_tpu/market/position/engine_xccy.py``. Risk views:
 - domestic delta/gamma: partials in the domestic quotes (XCCY curve
   held);
 - foreign delta/gamma: partials in the foreign quotes with the XCCY
   curve HELD FIXED;
 - basis delta/gamma: through the XCCY bootstrap (spreads -> node DFs ->
   PV);
 - cross-gamma (foreign x basis): the full mixed second derivative of
   PV(for_rates, spreads) through both the pricing and the bootstrap.

Everything is one function PV(dom_rates, for_rates, spreads) composed
from the OIS bootstrap, the XCCY bootstrap (through a static
foreign-interpolation plan where the foreign curve is on a simple scheme:
the foreign grid's times are fixed even where its DFs are differentiated;
on a fitted scheme the bootstrap fits the foreign grid itself) and the
leg pricers, on every interpolation scheme; all
requested outputs come back as one packed tensor, one device->host copy.
"""

from __future__ import annotations

from typing import Set

import numpy as np
import torch
from torch.func import jacfwd, jacrev

from ...ops.bootstrap import bootstrap_ois
from ...ops.interpolation import (_SIMPLE_SCHEMES, interp_df,
                                  simple_interp_plan)
from ...ops.interpolation import plan_to_torch as interp_plan_to_torch
from ...ops.pricers import FixedLegTensor, pv_fixed_leg, pv_float_leg
from ...ops.xccy_bootstrap import bootstrap_xccy
from ...requests.results import (AnalyticsResult, Cashflows, CrossGamma,
                                 Delta, Gamma, Risk, Valuation)
from ...trades.rates.swap_fixed_leg import SwapFixedLeg
from ...trades.rates.xccy_basis_swap import \
    float_leg_xccy_tensor as _float_leg_xccy_tensor
from ...trades.rates.xccy_curve import find_xccy_curve
from ...utils.day_count import DayCountTypes
from ...utils.error import LibError
from ...utils.global_types import CurveTypes, RequestTypes, SwapTypes
from ...utils.helpers import times_from_dates, to_tenor
from .engine import memo_tensor


def basis_curve_type(foreign_ccy, domestic_ccy) -> CurveTypes:
    name = f"{foreign_ccy.name}_{domestic_ccy.name}_BASIS"
    try:
        return CurveTypes[name]
    except KeyError:
        raise LibError(
            f"No CurveTypes member {name} for the basis risk ladder — "
            f"add it to utils/global_types.py rather than mislabeling "
            f"the ladder") from None


def _fixed_exchange_times(derivative, value_dt):
    return (times_from_dates(derivative._effective_dt, value_dt,
                             DayCountTypes.ACT_ACT_ISDA),
            times_from_dates(derivative._maturity_dt, value_dt,
                             DayCountTypes.ACT_ACT_ISDA))


def _foreign_fixed_tensor(derivative, for_leg, value_dt) -> FixedLegTensor:
    """The fixed foreign leg discounted on the XCCY grid: times in
    ACT/365F."""
    xdc = DayCountTypes.ACT_365F
    return FixedLegTensor(
        payment_times=np.asarray(
            times_from_dates(for_leg._payment_dts, value_dt, xdc)),
        payments=np.array(for_leg._payments, dtype=np.float64),
        principal=np.float64(for_leg._principal * for_leg._notional),
        leg_sign=np.float64(
            1.0 if for_leg._leg_type == SwapTypes.RECEIVE else -1.0),
        value_time=np.float64(0.0))


def _exchange_pv(dfs, times, it, q, amts):
    """PV of the two notional exchanges at times ``q`` [2] (those before
    the valuation date dropped)."""
    d = interp_df(q, times, dfs, it)
    return torch.where(q >= 0.0, amts * d, 0.0).sum()


def compute_xccy(engine, derivative, reqs: Set[RequestTypes]
                 ) -> AnalyticsResult:
    model = engine.model
    dev = engine.device
    # bracket access raises LibError naming the missing curve (strict
    # routing: never price against a half-populated model)
    dom_curve = model.curves[derivative._domestic_floating_index.name]
    for_curve = model.curves[derivative._foreign_floating_index.name]
    _, xccy_curve = find_xccy_curve(model, derivative)
    value_dt = dom_curve._value_dt

    dom_it = dom_curve._interp_type
    for_it = for_curve._interp_type
    xccy_it = xccy_curve._interp_type
    spot_fx = xccy_curve._spot_fx

    # --- compile legs ---------------------------------------------------
    dom_leg = derivative._domestic_leg
    for_leg = derivative._foreign_leg
    dom_is_fixed = isinstance(dom_leg, SwapFixedLeg)
    for_is_fixed = isinstance(for_leg, SwapFixedLeg)

    if dom_is_fixed:
        dom_t = engine._leg(dom_leg.tensor(value_dt))
        eff_t, mat_t = _fixed_exchange_times(derivative, value_dt)
        n = derivative._domestic_notional
        s = 1.0 if derivative._domestic_leg_type == SwapTypes.RECEIVE \
            else -1.0
        dom_q = engine._f64([eff_t, mat_t])
        dom_amts = engine._f64([-n * s, n * s])
    else:
        dom_t = engine._leg(dom_leg.tensor(value_dt,
                                           index_dc=dom_curve._dc_type))

    if for_is_fixed:
        for_t = engine._leg(memo_tensor(
            derivative, ("xccy_for_fixed", value_dt.serial()),
            lambda: _foreign_fixed_tensor(derivative, for_leg, value_dt)))
        xdc = DayCountTypes.ACT_365F
        n = derivative._foreign_notional
        s = 1.0 if for_leg._leg_type == SwapTypes.RECEIVE else -1.0
        for_q = engine._f64([
            times_from_dates(derivative._effective_dt, value_dt, xdc),
            times_from_dates(derivative._maturity_dt, value_dt, xdc)])
        for_amts = engine._f64([-n * s, n * s])
    else:
        for_t = engine._leg(memo_tensor(
            derivative, ("xccy_for_float", value_dt.serial(),
                         for_curve._dc_type),
            lambda: _float_leg_xccy_tensor(for_leg, value_dt,
                                           for_curve._dc_type)))

    Dp = engine._ois_consts(dom_curve)
    Fp = engine._ois_consts(for_curve)
    X = engine._xccy_consts(xccy_curve)
    if for_curve is xccy_curve._foreign_curve:
        fplan = X["fplan"]
    elif for_it in _SIMPLE_SCHEMES:
        # the basis bootstrap's foreign queries on this foreign curve's
        # own (static) grid
        p = xccy_curve._plan
        fplan = interp_plan_to_torch(simple_interp_plan(
            np.concatenate([p.start_t, p.end_t, p.pay_t_foreign]),
            for_curve._times.numpy(), for_it), dev)
    else:
        fplan = None         # fitted on the foreign grid in the bootstrap
    xts = X["times"]

    want = (RequestTypes.VALUE in reqs, RequestTypes.DELTA in reqs,
            RequestTypes.GAMMA in reqs)
    n_d = len(dom_curve.swap_rates)
    n_f = len(for_curve.swap_rates)
    n_s = len(xccy_curve.basis_spreads)

    def pv_fn(dom_rates, for_rates, xccy_dfs):
        dom_times, dom_dfs = bootstrap_ois(dom_rates, Dp["plan"])
        for_times, for_dfs = bootstrap_ois(for_rates, Fp["plan"])

        # domestic leg on the domestic OIS curve
        if dom_is_fixed:
            dom_pv = pv_fixed_leg(dom_dfs, dom_times, dom_it, dom_t)
            dom_pv = dom_pv + _exchange_pv(dom_dfs, dom_times, dom_it,
                                           dom_q, dom_amts)
        else:
            dom_pv = pv_float_leg(dom_dfs, dom_it, dom_t, times=dom_times)

        # foreign leg: projected on foreign OIS, discounted on XCCY
        if for_is_fixed:
            for_pv = pv_fixed_leg(xccy_dfs, xts, xccy_it, for_t)
            for_pv = for_pv + _exchange_pv(xccy_dfs, xts, xccy_it, for_q,
                                           for_amts)
        else:
            for_pv = pv_float_leg(xccy_dfs, xccy_it, for_t, idx_dfs=for_dfs,
                                  idx_interp_type=for_it, times=xts,
                                  idx_times=for_times)
        return dom_pv + spot_fx * for_pv

    def xccy_dfs_fn(spreads, for_rates):
        for_times, for_dfs = bootstrap_ois(for_rates, Fp["plan"])
        _, dfs = bootstrap_xccy(spreads, X["pv_dom"], for_dfs, X["spot_fx"],
                                X["plan"], for_it, fplan,
                                foreign_times=for_times)
        return dfs

    def basis_pv(spreads, dom_rates, for_rates):
        return pv_fn(dom_rates, for_rates, xccy_dfs_fn(spreads, for_rates))

    dom_rates, for_rates, spreads = Dp["rates"], Fp["rates"], X["spreads"]
    xdfs0 = X["dfs"]
    value = delta = gamma = None
    if any(want):
        parts, sizes = [], []
        if want[0]:
            parts.append(pv_fn(dom_rates, for_rates, xdfs0).reshape(1))
            sizes.append(("pv", ()))
        if want[1]:
            parts += [jacrev(pv_fn, argnums=0)(dom_rates, for_rates, xdfs0),
                      jacrev(pv_fn, argnums=1)(dom_rates, for_rates, xdfs0),
                      jacrev(basis_pv, argnums=0)(spreads, dom_rates,
                                                  for_rates)]
            sizes += [("d_dom", (n_d,)), ("d_for", (n_f,)),
                      ("d_basis", (n_s,))]
        if want[2]:
            # cross-gamma foreign x basis: the full mixed second
            # derivative of f(for, spreads)
            def f_cross(fr, s):
                return pv_fn(dom_rates, fr, xccy_dfs_fn(s, fr))
            parts += [
                jacfwd(jacrev(pv_fn, argnums=0), argnums=0)(
                    dom_rates, for_rates, xdfs0).reshape(-1),
                jacfwd(jacrev(pv_fn, argnums=1), argnums=1)(
                    dom_rates, for_rates, xdfs0).reshape(-1),
                jacfwd(jacrev(basis_pv, argnums=0), argnums=0)(
                    spreads, dom_rates, for_rates).reshape(-1),
                jacfwd(jacrev(f_cross, argnums=0), argnums=1)(
                    for_rates, spreads).reshape(-1)]
            sizes += [("g_dom", (n_d, n_d)), ("g_for", (n_f, n_f)),
                      ("g_basis", (n_s, n_s)), ("cross", (n_f, n_s))]
        raw = engine._unpack(torch.cat(parts), sizes)

        dom_ccy = derivative._domestic_currency
        basis_ct = basis_curve_type(derivative._foreign_currency, dom_ccy)
        dom_tenors = to_tenor(list(dom_curve.swap_times))
        for_tenors = to_tenor(list(for_curve.swap_times))
        basis_tenors = to_tenor(list(xccy_curve.swap_times))
        if want[0]:
            value = Valuation(float(raw["pv"]), dom_ccy)
        if want[1]:
            delta = Risk([
                Delta(raw["d_dom"] * 1e-4, dom_tenors, dom_ccy,
                      derivative._domestic_floating_index),
                Delta(raw["d_for"] * 1e-4, for_tenors, dom_ccy,
                      derivative._foreign_floating_index),
                Delta(raw["d_basis"] * 1e-4, basis_tenors, dom_ccy,
                      basis_ct)])
        if want[2]:
            cross_gamma = CrossGamma(
                risk_matrix=raw["cross"] * 1e-8,
                tenors_curve1=for_tenors, tenors_curve2=basis_tenors,
                currency=dom_ccy,
                curve_type_1=derivative._foreign_floating_index,
                curve_type_2=basis_ct)
            gamma = Risk([
                Gamma(raw["g_dom"] * 1e-8, dom_tenors, dom_ccy,
                      derivative._domestic_floating_index),
                Gamma(raw["g_for"] * 1e-8, for_tenors, dom_ccy,
                      derivative._foreign_floating_index),
                Gamma(raw["g_basis"] * 1e-8, basis_tenors, dom_ccy,
                      basis_ct)],
                cross_gammas=[cross_gamma])

    cashflows = None
    if RequestTypes.CASHFLOWS in reqs:
        pay_dom = dom_leg._leg_type == SwapTypes.PAY
        if dom_is_fixed:
            dom_leg.value(value_dt, dom_curve)
        else:
            dom_leg.value(value_dt, dom_curve, dom_curve)
        if for_is_fixed:
            for_leg.value(value_dt, xccy_curve)
        else:
            for_leg.value(value_dt, xccy_curve, for_curve)
        items = engine._extract_leg_cashflows(
            dom_leg, "Domestic_Pay" if pay_dom else "Domestic_Rec")
        items += engine._extract_leg_cashflows(
            for_leg, "Foreign_Rec" if pay_dom else "Foreign_Pay")
        cashflows = Cashflows(items, derivative._domestic_currency)

    return AnalyticsResult(value=value, risk=delta, gamma=gamma,
                           cashflows=cashflows)
