"""Bond / FRN engine paths: AD delta ladders and gamma matrices against
the currency's default OIS curve, and the leg tensors the book compiler
reads too.

Port of ``adrates_tpu/market/position/engine_credit.py``: a bond is the
fixed-leg pricer on the currency OIS curve; an FRN is the float-leg
pricer plus principal, single-curve when it projects on its discount
curve, else with ladders and gammas against both curves and their
cross-gamma. Bond payment times are on ACT_ACT_ISDA, the basis
``Bond.value`` queries its curve with (not the bond's own day count);
FRN times are on the FRN's own day count, and its index alphas on the
index curve's.
"""

from __future__ import annotations

import numpy as np

from ...ops.bootstrap import bootstrap_ois
from ...ops.pricers import FixedLegTensor, FloatLegTensor, pv_float_leg
from ...requests.results import (AnalyticsResult, CashflowItem, Cashflows,
                                 CrossGamma, Delta, Gamma, Risk, Valuation)
from ...utils.currency import CurrencyTypes
from ...utils.day_count import DayCount, DayCountTypes
from ...utils.error import LibError
from ...utils.global_types import CurveTypes, RequestTypes
from ...utils.helpers import times_from_dates, to_tenor
from .engine import memo_tensor

_DEFAULT_OIS = {
    CurrencyTypes.GBP: "GBP_OIS_SONIA",
    CurrencyTypes.USD: "USD_OIS_SOFR",
    CurrencyTypes.EUR: "EUR_OIS_ESTR",
    CurrencyTypes.JPY: "JPY_OIS_TONAR",
    CurrencyTypes.CHF: "CHF_OIS_SARON",
    CurrencyTypes.AUD: "AUD_OIS_AONIA",
    CurrencyTypes.CAD: "CAD_OIS_CORRA",
}


def _default_curve(engine, currency):
    if currency not in _DEFAULT_OIS:
        raise LibError(f"No default OIS curve for currency {currency}")
    name = _DEFAULT_OIS[currency]
    return name, getattr(engine.model.curves, name)


def _bond_tensor(bond, value_dt) -> FixedLegTensor:
    """A bond as a fixed-leg tensor: coupons (+ amortizing principal
    repayments) as the payment vector, a bullet principal on the final
    row."""
    dc = DayCountTypes.ACT_ACT_ISDA
    payment_times = np.asarray(
        times_from_dates(bond._payment_dts, value_dt, dc))
    amounts = np.array(bond._coupon_payments, dtype=float)
    if bond._is_amortizing:
        amounts = amounts + np.array(bond._principal_payments, dtype=float)
        principal = 0.0
    else:
        principal = bond._face_value
    return FixedLegTensor(
        payment_times=payment_times,
        payments=amounts,
        principal=np.float64(principal),
        leg_sign=np.float64(1.0),  # investor receives
        value_time=np.float64(times_from_dates(value_dt, value_dt, dc)))


def _frn_tensor(frn, value_dt, index_dc=None) -> FloatLegTensor:
    """An FRN as a float-leg tensor: the cap/floor and a known first
    fixing as the tensor's static switches, the principal on the final
    coupon."""
    dc = frn._dc_type
    n = frn._num_coupons
    override = frn._first_fixing_rate is not None
    has_cap_floor = frn._cap_rate is not None or frn._floor_rate is not None
    if index_dc is None or index_dc == dc:
        index_alphas = np.array(frn._year_fracs, dtype=np.float64)
    else:
        counter = DayCount(index_dc)
        index_alphas = np.array(
            [counter.year_frac(s, e)[0]
             for s, e in zip(frn._start_accrued_dts, frn._end_accrued_dts)],
            dtype=np.float64)
    return FloatLegTensor(
        payment_times=np.asarray(
            times_from_dates(frn._payment_dts, value_dt, dc)),
        start_times=np.asarray(
            times_from_dates(frn._start_accrued_dts, value_dt, dc)),
        end_times=np.asarray(
            times_from_dates(frn._end_accrued_dts, value_dt, dc)),
        pay_alphas=np.array(frn._year_fracs, dtype=np.float64),
        index_alphas=index_alphas,
        spreads=np.full(n, frn._quoted_margin),
        notionals=np.full(n, float(frn._face_value)),
        principal=np.float64(frn._face_value),
        leg_sign=np.float64(1.0),
        value_time=np.float64(times_from_dates(value_dt, value_dt, dc)),
        first_fixing_rate=np.float64(frn._first_fixing_rate
                                     if override else 0.0),
        notional_exchange_amount=np.float64(0.0),
        effective_time=np.float64(0.0),
        maturity_time=np.float64(0.0),
        cap_rate=np.float64(frn._cap_rate if frn._cap_rate is not None
                            else np.inf),
        floor_rate=np.float64(frn._floor_rate
                              if frn._floor_rate is not None else -np.inf),
        override_first=override,
        notional_exchange=False,
        has_cap_floor=has_cap_floor)


def compute_bond(engine, derivative, reqs) -> AnalyticsResult:
    curve_name, curve = _default_curve(engine, derivative._currency)
    value_dt = curve._value_dt
    tensor = memo_tensor(derivative, value_dt.serial(),
                         lambda: _bond_tensor(derivative, value_dt))

    raw = engine._swap_analytics(curve, tensor, None, reqs)
    out = engine._package_outputs(raw, reqs, derivative._currency,
                                  CurveTypes[curve_name], curve.swap_times)

    cashflows = None
    if RequestTypes.CASHFLOWS in reqs:
        derivative.value(value_dt, curve)
        items = []
        for i, dt in enumerate(derivative._payment_dts):
            items.append(CashflowItem(
                payment_date=dt,
                notional=float(derivative._principal_schedule[i]),
                payment_fraction=derivative._coupon,
                accrual_period=float(derivative._year_fracs[i]),
                amount=float(derivative._coupon_payments[i]),
                discount_factor=float(derivative._payment_dfs[i]),
                discounted_amount=float(derivative._coupon_pvs[i]),
                leg_type="Fixed_Coupon"))
            prin_pv = derivative._principal_pvs[i]
            prin_amt = derivative._principal_payments[i] \
                if derivative._is_amortizing else \
                (derivative._face_value
                 if i == len(derivative._payment_dts) - 1 else 0.0)
            if prin_amt > 0:
                items.append(CashflowItem(
                    payment_date=dt, notional=float(prin_amt),
                    payment_fraction=1.0, accrual_period=0.0,
                    amount=float(prin_amt),
                    discount_factor=float(derivative._payment_dfs[i]),
                    discounted_amount=float(prin_pv),
                    leg_type="Principal"))
        cashflows = Cashflows(items, derivative._currency)

    return AnalyticsResult(value=out.get("value"), risk=out.get("delta"),
                           gamma=out.get("gamma"), cashflows=cashflows)


def compute_frn(engine, derivative, reqs) -> AnalyticsResult:
    disc_name, disc_curve = _default_curve(engine, derivative._currency)
    idx_name = derivative._floating_index.name
    idx_curve = getattr(engine.model.curves, idx_name)
    value_dt = disc_curve._value_dt
    tensor = memo_tensor(
        derivative, (value_dt.serial(), idx_curve._dc_type),
        lambda: _frn_tensor(derivative, value_dt,
                            index_dc=idx_curve._dc_type))
    single_curve = idx_name == disc_name

    if single_curve:
        raw = engine._swap_analytics(disc_curve, None, tensor, reqs)
        out = engine._package_outputs(raw, reqs, derivative._currency,
                                      CurveTypes[disc_name],
                                      disc_curve.swap_times)
        value = out.get("value")
        risk = out.get("delta")
        gamma = out.get("gamma")
    else:
        # Dual-curve FRN: ladders against BOTH curves from one jacrev over
        # the two quote vectors (the reference raises here).
        disc_it = disc_curve._interp_type
        idx_it = idx_curve._interp_type
        n_disc = len(disc_curve.swap_rates)
        n_idx = len(idx_curve.swap_rates)
        want = (RequestTypes.VALUE in reqs, RequestTypes.DELTA in reqs,
                RequestTypes.GAMMA in reqs)
        D = engine._ois_consts(disc_curve)
        I = engine._ois_consts(idx_curve)
        lt = engine._leg(tensor)

        def pv_fn(d_rates, i_rates):
            d_times, d_dfs = bootstrap_ois(d_rates, D["plan"])
            i_times, i_dfs = bootstrap_ois(i_rates, I["plan"])
            return pv_float_leg(d_dfs, disc_it, lt, idx_dfs=i_dfs,
                                idx_interp_type=idx_it, times=d_times,
                                idx_times=i_times)

        value = risk = gamma = None
        if any(want):
            packed = engine._two_curve_analytics(pv_fn, want)(D["rates"],
                                                              I["rates"])
            sizes = []
            if want[0]:
                sizes.append(("pv", ()))
            if want[1]:
                sizes += [("d0", (n_disc,)), ("d1", (n_idx,))]
            if want[2]:
                sizes += [("g0", (n_disc, n_disc)), ("g1", (n_idx, n_idx)),
                          ("cross", (n_disc, n_idx))]
            raw = engine._unpack(packed, sizes)

            disc_tenors = to_tenor(list(disc_curve.swap_times))
            idx_tenors = to_tenor(list(idx_curve.swap_times))
            if want[0]:
                value = Valuation(float(raw["pv"]), derivative._currency)
            if want[1]:
                risk = Risk([
                    Delta(raw["d0"] * 1e-4, disc_tenors,
                          derivative._currency, CurveTypes[disc_name]),
                    Delta(raw["d1"] * 1e-4, idx_tenors,
                          derivative._currency, CurveTypes[idx_name])])
            if want[2]:
                cross = CrossGamma(
                    risk_matrix=raw["cross"] * 1e-8,
                    tenors_curve1=disc_tenors, tenors_curve2=idx_tenors,
                    currency=derivative._currency,
                    curve_type_1=CurveTypes[disc_name],
                    curve_type_2=CurveTypes[idx_name])
                gamma = Risk([
                    Gamma(raw["g0"] * 1e-8, disc_tenors,
                          derivative._currency, CurveTypes[disc_name]),
                    Gamma(raw["g1"] * 1e-8, idx_tenors,
                          derivative._currency, CurveTypes[idx_name])],
                    cross_gammas=[cross])

    cashflows = None
    if RequestTypes.CASHFLOWS in reqs:
        derivative.value(value_dt, disc_curve, idx_curve)
        items = []
        for i, dt in enumerate(derivative._payment_dts):
            if abs(derivative._coupon_payments[i]) > 1e-10:
                items.append(CashflowItem(
                    payment_date=dt, notional=derivative._face_value,
                    payment_fraction=float(derivative._rates[i]),
                    accrual_period=float(derivative._year_fracs[i]),
                    amount=float(derivative._coupon_payments[i]),
                    discount_factor=float(derivative._payment_dfs[i]),
                    discounted_amount=float(derivative._coupon_payments[i]
                                            * derivative._payment_dfs[i]),
                    leg_type="Floating_Coupon"))
            if i == len(derivative._payment_dts) - 1:
                df = derivative._payment_dfs[i]
                items.append(CashflowItem(
                    payment_date=dt, notional=derivative._face_value,
                    payment_fraction=1.0, accrual_period=0.0,
                    amount=float(derivative._face_value),
                    discount_factor=float(df),
                    discounted_amount=float(derivative._face_value * df),
                    leg_type="Principal"))
        cashflows = Cashflows(items, derivative._currency)

    return AnalyticsResult(value=value, risk=risk, gamma=gamma,
                           cashflows=cashflows)
