"""Inflation swap engine paths: ZCIS and YoY with AD risk to both the
discount curve and the ZCIS breakeven curve, and the CPI-reference
classification the book compiler reads too.

Port of ``adrates_tpu/market/position/engine_inflation.py``: deltas and
gammas to the discount quotes and the breakevens, with the discount x
breakeven cross-gamma. CPI references are classified at trade-compile
time: lagged dates covered by historical fixings become constants; later
ones become seas * base_cpi * factor(t), the factor curve rebuilt
differentiably from the breakeven vector.
"""

from __future__ import annotations

from typing import Set

import numpy as np
import torch

from ...market.curves.inflation_curve import InflationCurve
from ...ops.bootstrap import bootstrap_ois
from ...ops.interpolation import interp_df, interp_fit
from ...ops.pricers import pv_fixed_leg
from ...requests.results import (AnalyticsResult, CashflowItem, Cashflows,
                                 CrossGamma, Delta, Gamma, Risk, Valuation)
from ...utils.currency import CurrencyTypes
from ...utils.day_count import DayCount, DayCountTypes
from ...utils.error import LibError
from ...utils.global_types import CurveTypes, RequestTypes, SwapTypes
from ...utils.helpers import times_from_dates, to_tenor

_DEFAULT_OIS = {
    CurrencyTypes.GBP: "GBP_OIS_SONIA",
    CurrencyTypes.USD: "USD_OIS_SOFR",
    CurrencyTypes.EUR: "EUR_OIS_ESTR",
    CurrencyTypes.JPY: "JPY_OIS_TONAR",
    CurrencyTypes.CHF: "CHF_OIS_SARON",
    CurrencyTypes.AUD: "AUD_OIS_AONIA",
    CurrencyTypes.CAD: "CAD_OIS_CORRA",
}

_DEFAULT_INFL_CT = {
    CurrencyTypes.GBP: CurveTypes.GBP_RPI_INFLATION,
    CurrencyTypes.USD: CurveTypes.USD_CPI_INFLATION,
    CurrencyTypes.EUR: CurveTypes.EUR_HICP_INFLATION,
}


def _curves_for(engine, derivative):
    ccy = derivative._inflation_index._currency
    if ccy not in _DEFAULT_OIS:
        raise LibError(f"No default OIS curve for currency {ccy}")
    ois_curve = getattr(engine.model.curves, _DEFAULT_OIS[ccy])
    infl_curve = derivative._inflation_index._inflation_curve
    if infl_curve is None:
        for curve in engine.model._curves_dict.values():
            if isinstance(curve, InflationCurve):
                infl_curve = curve
                break
    if infl_curve is None:
        raise LibError(
            "No inflation curve available: set one on the index via "
            "set_inflation_curve() or model.build_inflation_curve().")
    infl_ct = getattr(infl_curve, "_curve_type", None) \
        or _DEFAULT_INFL_CT.get(ccy, CurveTypes.GBP_RPI_INFLATION)
    return ois_curve, infl_curve, infl_ct


def _cpi_ref(index, infl_curve, ref_dt, value_dt):
    """Classify a CPI reference: (is_fixed, fixed_value, t_curve, seas).

    The lag is applied; if the lagged date has a historical fixing the
    value is that fixing times the seasonal factor, else the reference is
    seas * base_cpi * factor(t_curve) with t_curve in the inflation
    curve's day count from its value date."""
    lagged = index._apply_lag(ref_dt)
    hist = index._get_historical_index(lagged)
    seas = index._seasonality_factors.get(lagged.m(), 1.0) \
        if index._use_seasonality else 1.0
    if hist is not None:
        return True, hist * seas, 0.0, seas
    dc = DayCount(infl_curve._dc_type)
    t = dc.year_frac(infl_curve._value_dt, lagged)[0]
    return False, 0.0, t, seas


def _factor_fn(infl_curve):
    """factor(t) interpolator over the (differentiable) factor grid; the
    pillar-time grid is a constant tensor argument."""
    it = infl_curve._interp_type

    def factor_at(breakevens, t_query, swap_times):
        factors = torch.pow(1.0 + breakevens, swap_times)
        times = torch.cat([swap_times.new_zeros(1), swap_times])
        factors = torch.cat([factors.new_ones(1), factors])
        aux = interp_fit(times, factors, it)
        return interp_df(t_query, times, factors, it, aux)

    return factor_at


def _risk_package(engine, pv_fn, ois_rates, breakevens, reqs, ccy, ois_ct,
                  infl_ct, ois_tenors, infl_tenors):
    """PV + both delta ladders + both gamma matrices + the discount x
    breakeven cross-gamma of ``pv_fn(ois_rates, breakevens)``, computed
    as one packed tensor and copied to the host once."""
    want = (RequestTypes.VALUE in reqs, RequestTypes.DELTA in reqs,
            RequestTypes.GAMMA in reqs)
    if not any(want):
        return None, None, None
    n0 = int(ois_rates.shape[0])
    n1 = int(breakevens.shape[0])
    packed = engine._two_curve_analytics(pv_fn, want)(ois_rates, breakevens)

    sizes = []
    if want[0]:
        sizes.append(("pv", ()))
    if want[1]:
        sizes += [("d0", (n0,)), ("d1", (n1,))]
    if want[2]:
        sizes += [("g0", (n0, n0)), ("g1", (n1, n1)), ("cross", (n0, n1))]
    raw = engine._unpack(packed, sizes)

    value = delta = gamma = None
    if want[0]:
        value = Valuation(float(raw["pv"]), ccy)
    if want[1]:
        delta = Risk([
            Delta(raw["d0"] * 1e-4, ois_tenors, ccy, ois_ct),
            Delta(raw["d1"] * 1e-4, infl_tenors, ccy, infl_ct)])
    if want[2]:
        cross_gamma = CrossGamma(
            risk_matrix=raw["cross"] * 1e-8,
            tenors_curve1=ois_tenors, tenors_curve2=infl_tenors,
            currency=ccy, curve_type_1=ois_ct, curve_type_2=infl_ct)
        gamma = Risk([
            Gamma(raw["g0"] * 1e-8, ois_tenors, ccy, ois_ct),
            Gamma(raw["g1"] * 1e-8, infl_tenors, ccy, infl_ct)],
            cross_gammas=[cross_gamma])
    return value, delta, gamma


def _infl_consts(engine, infl_curve) -> dict:
    """An inflation curve's breakevens and pillar times on the device."""
    return engine._consts(infl_curve, "infl", lambda: dict(
        breakevens=engine._f64(infl_curve.breakeven_rates),
        times=engine._f64(infl_curve.swap_times)))


def compute_yoy_iis(engine, derivative, reqs: Set[RequestTypes]
                    ) -> AnalyticsResult:
    ois_curve, infl_curve, infl_ct = _curves_for(engine, derivative)
    value_dt = ois_curve._value_dt
    index = derivative._inflation_index
    leg = derivative._inflation_leg
    ccy = index._currency
    ois_ct = CurveTypes[_DEFAULT_OIS[ccy]]

    fixed_t = engine._leg(derivative._fixed_leg.tensor(value_dt))

    # YoY leg compile: classify every CPI reference
    n = len(leg._payment_dts)
    rows = []
    for i in range(n):
        if leg._payment_dts[i] <= value_dt:
            continue
        s_fixed, s_val, s_t, _ = _cpi_ref(index, infl_curve,
                                          leg._yoy_start_dts[i], value_dt)
        e_fixed, e_val, e_t, _ = _cpi_ref(index, infl_curve,
                                          leg._yoy_end_dts[i], value_dt)
        pay_t = times_from_dates(leg._payment_dts[i], value_dt,
                                 leg._dc_type)
        rows.append((s_fixed, s_val, s_t, e_fixed, e_val, e_t, pay_t,
                     leg._year_fracs[i]))

    def seas(dt):
        return index._seasonality_factors.get(index._apply_lag(dt).m(), 1.0) \
            if index._use_seasonality else 1.0

    live = [i for i in range(n) if leg._payment_dts[i] > value_dt]
    f64 = engine._f64

    def col(k):
        return f64([r[k] for r in rows])

    def flag(k):
        return torch.as_tensor(np.array([r[k] for r in rows], dtype=bool),
                               device=engine.device)

    C = dict(pay_t=torch.cat([col(6), f64([0.0])]), s_t=col(2), e_t=col(5),
             s_val=col(1), e_val=col(4), alphas=col(7),
             s_fixed=flag(0), e_fixed=flag(3),
             seas_s=f64([seas(leg._yoy_start_dts[i]) for i in live]),
             seas_e=f64([seas(leg._yoy_end_dts[i]) for i in live]))
    base_cpi = float(infl_curve._base_cpi)
    leg_sign = 1.0 if leg._leg_type == SwapTypes.RECEIVE else -1.0
    spread = float(leg._spread)
    notional = float(leg._notional)

    factor_at = _factor_fn(infl_curve)
    O = engine._ois_consts(ois_curve)
    Inf = _infl_consts(engine, infl_curve)
    it = ois_curve._interp_type

    def pv_fn(ois_rates, breakevens):
        times, dfs = bootstrap_ois(ois_rates, O["plan"])
        aux = interp_fit(times, dfs, it)
        out = interp_df(C["pay_t"], times, dfs, it, aux)
        df_pay = out[:-1] / out[-1]

        f_s = factor_at(breakevens, C["s_t"], Inf["times"])
        f_e = factor_at(breakevens, C["e_t"], Inf["times"])
        cpi_s = torch.where(C["s_fixed"], C["s_val"],
                            C["seas_s"] * base_cpi * f_s)
        cpi_e = torch.where(C["e_fixed"], C["e_val"],
                            C["seas_e"] * base_cpi * f_e)
        yoy = cpi_e / cpi_s - 1.0
        payments = notional * C["alphas"] * (yoy + spread)
        infl_pv = leg_sign * (payments * df_pay).sum()

        fixed_pv = pv_fixed_leg(dfs, times, it, fixed_t)
        return fixed_pv + infl_pv

    value, delta, gamma = _risk_package(
        engine, pv_fn, O["rates"], Inf["breakevens"], reqs, ccy, ois_ct,
        infl_ct, to_tenor(list(ois_curve.swap_times)),
        list(infl_curve.tenors))

    cashflows = None
    if RequestTypes.CASHFLOWS in reqs:
        derivative.value(value_dt, ois_curve, infl_curve)
        pay_fixed = derivative._fixed_leg._leg_type == SwapTypes.PAY
        items = engine._extract_leg_cashflows(
            derivative._fixed_leg,
            "Fixed_Pay" if pay_fixed else "Fixed_Rec")
        for i, dt in enumerate(leg._payment_dts):
            items.append(CashflowItem(
                payment_date=dt, notional=leg._notional,
                payment_fraction=float(leg._yoy_rates[i]),
                accrual_period=float(leg._year_fracs[i]),
                amount=float(leg._payments[i]),
                discount_factor=float(leg._dfs[i]),
                discounted_amount=float(leg._pvs[i]),
                leg_type="Inflation_Rec" if pay_fixed else "Inflation_Pay"))
        cashflows = Cashflows(items, ccy)

    return AnalyticsResult(value=value, risk=delta, gamma=gamma,
                           cashflows=cashflows)


def compute_zcis(engine, derivative, reqs: Set[RequestTypes]
                 ) -> AnalyticsResult:
    """ZCIS engine path (the reference has none). Single exchange: fixed
    N[(1+r)^T - 1] vs inflation N[I_T/I_0 - 1]."""
    ois_curve, infl_curve, infl_ct = _curves_for(engine, derivative)
    value_dt = ois_curve._value_dt
    index = derivative._inflation_index
    ccy = index._currency
    ois_ct = CurveTypes[_DEFAULT_OIS[ccy]]

    year_frac = derivative.year_frac()
    fixed_payment = derivative._notional \
        * ((1.0 + derivative._fixed_rate) ** year_frac - 1.0)
    fixed_sign = -1.0 if derivative._fixed_leg_type == SwapTypes.PAY \
        else 1.0
    infl_sign = -fixed_sign

    b_fixed, b_val, b_t, _ = _cpi_ref(index, infl_curve,
                                      derivative._effective_dt, value_dt)
    f_fixed, f_val, f_t, _ = _cpi_ref(index, infl_curve,
                                      derivative._maturity_dt, value_dt)
    seas_b = index._seasonality_factors.get(
        index._apply_lag(derivative._effective_dt).m(), 1.0) \
        if index._use_seasonality else 1.0
    seas_f = index._seasonality_factors.get(
        index._apply_lag(derivative._maturity_dt).m(), 1.0) \
        if index._use_seasonality else 1.0

    pay_t = times_from_dates(derivative._payment_dt, value_dt,
                             DayCountTypes.ACT_365F)
    live = derivative._payment_dt > value_dt

    factor_at = _factor_fn(infl_curve)
    O = engine._ois_consts(ois_curve)
    Inf = _infl_consts(engine, infl_curve)
    it = ois_curve._interp_type
    q = engine._f64([pay_t, 0.0])
    tq = engine._f64([b_t, f_t])
    base_cpi = float(infl_curve._base_cpi)
    notional = float(derivative._notional)
    fixed_amt = float(fixed_sign * fixed_payment)

    def pv_fn(ois_rates, breakevens):
        times, dfs = bootstrap_ois(ois_rates, O["plan"])
        aux = interp_fit(times, dfs, it)
        out = interp_df(q, times, dfs, it, aux)
        df_pay = out[0] / out[1] if live else out[0] * 0.0

        f_curve = factor_at(breakevens, tq, Inf["times"])
        cpi_b = b_val if b_fixed else seas_b * base_cpi * f_curve[0]
        cpi_f = f_val if f_fixed else seas_f * base_cpi * f_curve[1]
        infl_payment = notional * (cpi_f / cpi_b - 1.0)
        return (fixed_amt + infl_sign * infl_payment) * df_pay

    value, delta, gamma = _risk_package(
        engine, pv_fn, O["rates"], Inf["breakevens"], reqs, ccy, ois_ct,
        infl_ct, to_tenor(list(ois_curve.swap_times)),
        list(infl_curve.tenors))

    return AnalyticsResult(value=value, risk=delta, gamma=gamma)
