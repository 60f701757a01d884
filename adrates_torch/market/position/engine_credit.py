"""Bond and FRN leg tensors, as the book compiler reads them.

Port of ``_bond_tensor`` and ``_frn_tensor``
(``adrates_tpu/market/position/engine_credit.py:46``, ``:117``), host
numpy only. Bond payment times are on ACT_ACT_ISDA, the basis
``Bond.value`` queries its curve with (not the bond's own day count);
FRN times are on the FRN's own day count, and its index alphas on the
index curve's. The single-trade bond and FRN engine paths are not ported
yet.
"""

from __future__ import annotations

import numpy as np

from ...ops.pricers import FixedLegTensor, FloatLegTensor
from ...utils.day_count import DayCount, DayCountTypes
from ...utils.helpers import times_from_dates


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
