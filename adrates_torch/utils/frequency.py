"""Payment frequency conventions.

Parity: the reference's cavour/utils/frequency.py:39-73 — enum members and
their annual-frequency float values.
"""

from enum import Enum

from .error import LibError


class FrequencyTypes(Enum):
    ZERO = -1
    SIMPLE = 0
    ANNUAL = 1
    SEMI_ANNUAL = 2
    TRI_ANNUAL = 3
    QUARTERLY = 4
    MONTHLY = 12
    CONTINUOUS = 99


def annual_frequency(freq_type: FrequencyTypes) -> float:
    """Number of payments per year implied by the frequency convention.

    ZERO (zero-coupon) and SIMPLE both correspond to a single payment at
    maturity and map to -1 / 1 respectively in the reference; we return the
    values the reference's schedule math expects.
    """
    if isinstance(freq_type, FrequencyTypes) is False:
        raise LibError("Unknown frequency type " + str(freq_type))

    if freq_type == FrequencyTypes.CONTINUOUS:
        return -1.0
    if freq_type == FrequencyTypes.ZERO:
        # A zero-coupon schedule has a single period: treated as annual for
        # schedule generation purposes (reference frequency.py behavior).
        return 1.0
    if freq_type == FrequencyTypes.SIMPLE:
        return 1.0
    return float(freq_type.value)
