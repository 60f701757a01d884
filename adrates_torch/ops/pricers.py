"""Compiled leg containers (port of ``adrates_tpu/ops/pricers.py:36-76``).

Plain dataclasses of host numpy arrays, filled by the legs' ``tensor()``
at trade-compile time and consumed by the book compilers. The leg
pricers themselves (``pv_fixed_leg``/``pv_float_leg``) are not ported
yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np


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
