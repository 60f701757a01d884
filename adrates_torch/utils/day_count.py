"""ISDA 2006 day-count conventions.

Behavioral parity with the reference's cavour/utils/day_count.py:91-370
(year_frac triplets per convention; days_in_year fixed denominators).
"""

from __future__ import annotations

from enum import Enum

from .date import Date, datediff, is_leap_year
from .error import LibError
from .frequency import FrequencyTypes, annual_frequency
from .global_vars import gDaysInYear


class DayCountTypes(Enum):
    ZERO = 0
    THIRTY_360_BOND = 1
    THIRTY_E_360 = 2
    THIRTY_E_360_ISDA = 3
    THIRTY_E_PLUS_360 = 4
    ACT_ACT_ISDA = 5
    ACT_ACT_ICMA = 6
    ACT_365F = 7
    ACT_360 = 8
    ACT_365L = 9
    SIMPLE = 10


def is_last_day_of_feb(dt: Date) -> bool:
    if dt.m() != 2:
        return False
    last = 29 if is_leap_year(dt.y()) else 28
    return dt.d() == last


class DayCount:
    """Fractional day count between two dates under a named convention."""

    def __init__(self, dcc_type: DayCountTypes):
        if dcc_type not in DayCountTypes:
            raise LibError("Need to pass DayCountTypes")
        self._type = dcc_type

    # ------------------------------------------------------------------

    def year_frac(self,
                  dt1: Date,
                  dt2: Date,
                  dt3: Date = None,
                  freq_type: FrequencyTypes = FrequencyTypes.ANNUAL,
                  is_termination_date: bool = False):
        """(accrual_factor, numerator, denominator) between dt1 and dt2.

        dt3 is the end of the full coupon period (needed by ACT_ACT_ICMA and
        ACT_365L bond-accrual conventions).
        """
        d1, m1, y1 = dt1.d(), dt1.m(), dt1.y()
        d2, m2, y2 = dt2.d(), dt2.m(), dt2.y()
        t = self._type

        if t == DayCountTypes.THIRTY_360_BOND:
            # ISDA 2006 4.16(f): 30/360 Bond Basis
            if d1 == 31:
                d1 = 30
            if d2 == 31 and d1 == 30:
                d2 = 30
            num = 360 * (y2 - y1) + 30 * (m2 - m1) + (d2 - d1)
            return num / 360, num, 360

        if t == DayCountTypes.THIRTY_E_360:
            # ISDA 2006 4.16(g): Eurobond basis
            if d1 == 31:
                d1 = 30
            if d2 == 31:
                d2 = 30
            num = 360 * (y2 - y1) + 30 * (m2 - m1) + (d2 - d1)
            return num / 360, num, 360

        if t == DayCountTypes.THIRTY_E_360_ISDA:
            # ISDA 2006 4.16(h): 30E/360 (ISDA)
            if d1 == 31 or is_last_day_of_feb(dt1):
                d1 = 30
            if d2 == 31:
                d2 = 30
            if is_last_day_of_feb(dt2) and not is_termination_date:
                d2 = 30
            num = 360 * (y2 - y1) + 30 * (m2 - m1) + (d2 - d1)
            return num / 360, num, 360

        if t == DayCountTypes.THIRTY_E_PLUS_360:
            if d1 == 31:
                d1 = 30
            if d2 == 31:
                m2 = m2 + 1
                d2 = 1
            num = 360 * (y2 - y1) + 30 * (m2 - m1) + (d2 - d1)
            return num / 360, num, 360

        if t in (DayCountTypes.ACT_ACT_ISDA, DayCountTypes.ZERO):
            denom1 = 366 if is_leap_year(y1) else 365
            denom2 = 366 if is_leap_year(y2) else 365
            if y1 == y2:
                num = dt2 - dt1
                return num / denom1, num, denom1
            days1 = datediff(dt1, Date(1, 1, y1 + 1))
            days2 = datediff(Date(1, 1, y2), dt2)
            acc = days1 / denom1 + days2 / denom2 + (y2 - y1 - 1.0)
            # num/den does not reproduce acc for split years; both returned
            return acc, days1 + days2, denom1 + denom2

        if t == DayCountTypes.ACT_ACT_ICMA:
            freq = annual_frequency(freq_type)
            if dt3 is None or freq is None:
                raise LibError("ACT_ACT_ICMA requires three dates and a freq")
            num = dt2 - dt1
            den = freq * (dt3 - dt1)
            return num / den, num, den

        if t == DayCountTypes.ACT_365F:
            num = dt2 - dt1
            return num / 365, num, 365

        if t == DayCountTypes.ACT_360:
            num = dt2 - dt1
            return num / 360, num, 360

        if t == DayCountTypes.ACT_365L:
            frequency = annual_frequency(freq_type)
            y3 = y2 if dt3 is None else dt3.y()
            num = dt2 - dt1
            den = 365
            if is_leap_year(y1):
                feb29 = Date(29, 2, y1)
            elif is_leap_year(y3):
                feb29 = Date(29, 2, y3)
            else:
                feb29 = Date(1, 1, 1900)
            if frequency == 1:
                if dt3 is not None and feb29 > dt1 and feb29 <= dt3:
                    den = 366
            else:
                if is_leap_year(y3):
                    den = 366
            return num / den, num, den

        if t == DayCountTypes.SIMPLE:
            num = dt2 - dt1
            return num / gDaysInYear, num, gDaysInYear

        raise LibError(str(t) + " is not one of DayCountTypes")

    # ------------------------------------------------------------------

    def days_in_year(self):
        """Fixed days-per-year denominator; raises when date-dependent."""
        t = self._type
        if t in (DayCountTypes.THIRTY_360_BOND, DayCountTypes.THIRTY_E_360,
                 DayCountTypes.THIRTY_E_360_ISDA,
                 DayCountTypes.THIRTY_E_PLUS_360, DayCountTypes.ACT_360):
            return 360
        if t is DayCountTypes.ACT_365F:
            return 365
        if t is DayCountTypes.SIMPLE:
            return gDaysInYear
        if t in (DayCountTypes.ACT_ACT_ISDA, DayCountTypes.ZERO):
            raise LibError("ACT/ACT (ISDA or ZERO) requires actual dates")
        if t is DayCountTypes.ACT_365L:
            raise LibError("ACT/365L depends on leap-day span")
        if t is DayCountTypes.ACT_ACT_ICMA:
            raise LibError("ACT/ACT ICMA needs coupon-period dates and freq")
        raise LibError(f"No fixed days-in-year for convention {t}")

    def __repr__(self):
        return str(self._type)
