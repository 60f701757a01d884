"""Holiday calendars and business-day adjustment.

14 regional calendars plus WEEKEND/NONE and INTERSECTION (multi-calendar for
cross-currency instruments), with ISDA business-day adjustment conventions.

Behavioral parity with the reference's cavour/utils/calendar.py:
 - adjust (calendar.py:139-217), add_business_days (221-255),
   is_business_day/is_holiday (257-324), per-country rules (328-1150),
   create_calendar_intersection (1153-1176).
Easter Monday is computed with the anonymous-Gregorian computus rather than
a hard-coded table; the result reproduces the reference's 1901-2200 table
(tested in tests/test_calendar.py).

For trade compilation at scale, ``holiday_mask(year)`` exposes a cached
per-year numpy boolean mask over Excel serials so that batched schedule
generation does array lookups instead of per-date rule evaluation.
"""

from __future__ import annotations

from enum import Enum
from functools import lru_cache
from typing import List

import numpy as np

from .date import Date, day_of_year, dmy_to_serial, is_leap_year, \
    serial_to_dmy, serial_weekday
from .error import LibError


class BusDayAdjustTypes(Enum):
    NONE = 1
    FOLLOWING = 2
    MODIFIED_FOLLOWING = 3
    PRECEDING = 4
    MODIFIED_PRECEDING = 5


class CalendarTypes(Enum):
    NONE = 1
    WEEKEND = 2
    AUSTRALIA = 3
    CANADA = 4
    FRANCE = 5
    GERMANY = 6
    ITALY = 7
    JAPAN = 8
    NEW_ZEALAND = 9
    NORWAY = 10
    SWEDEN = 11
    SWITZERLAND = 12
    TARGET = 13
    UNITED_STATES = 14
    UNITED_KINGDOM = 15
    INTERSECTION = 16


class DateGenRuleTypes(Enum):
    FORWARD = 1
    BACKWARD = 2


@lru_cache(maxsize=512)
def easter_sunday_day_of_year(year: int) -> int:
    """Day-of-year of Easter Sunday via the anonymous Gregorian computus."""
    a = year % 19
    b, c = divmod(year, 100)
    d, e = divmod(b, 4)
    f = (b + 8) // 25
    g = (b - f + 1) // 3
    h = (19 * a + b - d - g + 15) % 30
    i, k = divmod(c, 4)
    l = (32 + 2 * e + 2 * i - h - k) % 7
    m = (a + 11 * h + 22 * l) // 451
    month = (h + l - 7 * m + 114) // 31
    day = ((h + l - 7 * m + 114) % 31) + 1
    return day_of_year(day, month, year)


def easter_monday_day_of_year(year: int) -> int:
    """Day-of-year of Easter Monday (Easter Sunday + 1)."""
    return easter_sunday_day_of_year(year) + 1


class _EasterMondayTable:
    """Parity shim for the reference's 1901-2199 Easter Monday
    day-of-year lookup list (reference calendar.py:51-100, indexed
    ``easterMondayDay[y - 1901]``, 299 entries); entries come from the
    computus above instead of a hand-maintained table. Length matches
    the reference's list exactly (len/slices/iteration)."""

    _LEN = 299  # reference list covers 1901..2199 inclusive

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return [self[i] for i in range(*idx.indices(self._LEN))]
        if idx < 0:
            idx += self._LEN
        if not 0 <= idx < self._LEN:
            raise IndexError("easterMondayDay index out of range")
        return easter_monday_day_of_year(1901 + idx)

    def __len__(self):
        return self._LEN

    def __iter__(self):
        return (self[i] for i in range(self._LEN))


easterMondayDay = _EasterMondayTable()


# ---------------------------------------------------------------------------
# Per-calendar holiday rules. Each takes (d, m, y, weekday, doy) where doy is
# the 1-based day-of-year, and returns True if the date is a bank holiday.
# Weekends are handled separately by is_business_day.
# ---------------------------------------------------------------------------


def _holiday_none(d, m, y, wd, doy):
    return False


def _holiday_weekend(d, m, y, wd, doy):
    return wd in (Date.SAT, Date.SUN)


def _holiday_united_kingdom(d, m, y, wd, doy):
    if m == 1 and d == 1:
        return True
    if m == 1 and d in (2, 3) and wd == Date.MON:
        return True
    em = easter_monday_day_of_year(y)
    if doy == em or doy == em - 3:  # Easter Monday / Good Friday
        return True
    if m == 5 and d <= 7 and wd == Date.MON:  # early May bank holiday
        return True
    if m == 5 and d >= 25 and wd == Date.MON:  # spring bank holiday
        return True
    if m == 6 and d == 2 and y == 2022:  # spring bank holiday (moved)
        return True
    if m == 6 and d == 3 and y == 2022:  # Platinum Jubilee
        return True
    if m == 8 and d > 24 and wd == Date.MON:  # late summer bank holiday
        return True
    if m == 12 and d == 25:
        return True
    if m == 12 and d == 26:
        return True
    if m == 12 and d == 27 and wd in (Date.MON, Date.TUE):
        return True
    if m == 12 and d == 28 and wd in (Date.MON, Date.TUE):
        return True
    return False


def _holiday_united_states(d, m, y, wd, doy):
    if m == 1 and d == 1:
        return True
    if m == 1 and d in (2, 3) and wd == Date.MON:
        return True
    if m == 1 and 15 <= d < 22 and wd == Date.MON:  # MLK
        return True
    if m == 2 and 15 <= d < 22 and wd == Date.MON:  # Washington
        return True
    if m == 5 and 25 <= d <= 31 and wd == Date.MON:  # Memorial Day
        return True
    if m == 7 and d == 4:
        return True
    if m == 7 and d == 5 and wd == Date.MON:
        return True
    if m == 7 and d == 3 and wd == Date.FRI:
        return True
    if m == 9 and 1 <= d < 8 and wd == Date.MON:  # Labor Day
        return True
    if m == 10 and 8 <= d < 15 and wd == Date.MON:  # Columbus Day
        return True
    if m == 11 and d == 11:  # Veterans
        return True
    if m == 11 and d == 12 and wd == Date.MON:
        return True
    if m == 11 and d == 10 and wd == Date.FRI:
        return True
    if m == 11 and 22 <= d < 29 and wd == Date.THU:  # Thanksgiving
        return True
    if m == 12 and d == 24 and wd == Date.FRI:
        return True
    if m == 12 and d == 25:
        return True
    if m == 12 and d == 26 and wd == Date.MON:
        return True
    if m == 12 and d == 31 and wd == Date.FRI:
        return True
    return False


def _holiday_target(d, m, y, wd, doy):
    if m == 1 and d == 1:
        return True
    if m == 5 and d == 1:
        return True
    em = easter_monday_day_of_year(y)
    if doy == em or doy == em - 3:
        return True
    if m == 12 and d in (25, 26):
        return True
    return False


def _holiday_australia(d, m, y, wd, doy):
    if m == 1 and d == 1:
        return True
    if m == 1 and d == 26:
        return True
    if m == 1 and d in (27, 28) and wd == Date.MON:
        return True
    em = easter_monday_day_of_year(y)
    if doy == em - 3 or doy == em:
        return True
    if m == 4 and d == 25:  # ANZAC
        return True
    if m == 4 and d == 26 and wd == Date.MON:
        return True
    if m == 6 and 7 < d < 15 and wd == Date.MON:  # Queen's birthday
        return True
    if m == 8 and d < 8 and wd == Date.MON:  # bank holiday
        return True
    if m == 10 and d < 8 and wd == Date.MON:  # labour day
        return True
    if m == 12 and d == 25:
        return True
    if m == 12 and d == 26:
        return True
    if m == 12 and d in (26, 27, 28) and wd == Date.MON:
        return True
    return False


def _holiday_canada(d, m, y, wd, doy):
    if m == 1 and d == 1:
        return True
    if m == 1 and d in (2, 3) and wd == Date.MON:
        return True
    if m == 2 and 15 <= d < 22 and wd == Date.MON:  # Family Day
        return True
    em = easter_monday_day_of_year(y)
    if doy == em - 3:  # Good Friday
        return True
    if m == 5 and 18 <= d < 25 and wd == Date.MON:  # Victoria Day
        return True
    if m == 7 and d == 1:
        return True
    if m == 7 and d in (2, 3) and wd == Date.MON:
        return True
    if m == 8 and d < 8 and wd == Date.MON:  # Provincial
        return True
    if m == 9 and d < 8 and wd == Date.MON:  # Labour Day
        return True
    if m == 10 and 8 <= d < 15 and wd == Date.MON:  # Thanksgiving
        return True
    if m == 11 and d == 11:
        return True
    if m == 11 and d == 12 and wd == Date.MON:
        return True
    if m == 11 and d == 13 and wd == Date.MON:
        return True
    if m == 12 and d == 25:
        return True
    if m == 12 and d == 26:
        return True
    if m == 12 and d in (26, 27) and wd == Date.MON:
        return True
    if m == 12 and d == 28 and wd == Date.TUE:
        return True
    return False


def _holiday_france(d, m, y, wd, doy):
    if m == 1 and d == 1:
        return True
    em = easter_monday_day_of_year(y)
    if doy == em or doy == em - 3:
        return True
    if m == 5 and d == 1:
        return True
    if m == 5 and d == 8:  # Victory Day
        return True
    if doy == em + 38:  # Ascension
        return True
    if doy == em + 49:  # Pentecost (Whit Monday)
        return True
    if m == 7 and d == 14:  # Bastille
        return True
    if m == 8 and d == 15:  # Assumption
        return True
    if m == 11 and d == 1:  # All Saints
        return True
    if m == 11 and d == 11:  # Armistice
        return True
    if m == 12 and d in (25, 26):
        return True
    return False


def _holiday_germany(d, m, y, wd, doy):
    if m == 1 and d == 1:
        return True
    em = easter_monday_day_of_year(y)
    if doy == em or doy == em - 3:
        return True
    if m == 5 and d == 1:
        return True
    if doy == em + 38:  # Ascension
        return True
    if doy == em + 49:  # Pentecost
        return True
    if m == 10 and d == 3:  # German Unity Day
        return True
    if m == 12 and d in (24, 25, 26):
        return True
    return False


def _holiday_italy(d, m, y, wd, doy):
    if m == 1 and d == 1:
        return True
    if m == 1 and d == 6:  # Epiphany
        return True
    em = easter_monday_day_of_year(y)
    if doy == em or doy == em - 3:
        return True
    if m == 4 and d == 25:  # Liberation Day
        return True
    if m == 5 and d == 1:
        return True
    if m == 6 and d == 2 and y > 1999:  # Republic Day
        return True
    if m == 8 and d == 15:  # Assumption
        return True
    if m == 11 and d == 1:  # All Saints
        return True
    if m == 12 and d == 8:  # Immaculate Conception
        return True
    if m == 12 and d in (25, 26):
        return True
    return False


def _holiday_japan(d, m, y, wd, doy):
    if m == 1 and d == 1:
        return True
    if m == 1 and d in (2, 3) and wd == Date.MON:
        return True
    if m == 1 and 7 < d < 15 and wd == Date.MON:  # Coming of Age
        return True
    if m == 2 and d == 11:  # National Foundation
        return True
    if m == 2 and d == 12 and wd == Date.MON:
        return True
    if m == 2 and d == 23:  # Emperor's Birthday
        return True
    if m == 2 and d == 24 and wd == Date.MON:
        return True
    if m == 3 and d == 20:  # Vernal Equinox (approximate)
        return True
    if m == 3 and d == 21 and wd == Date.MON:
        return True
    if m == 4 and d == 29:  # Showa Day
        return True
    if m == 4 and d == 30 and wd == Date.MON:
        return True
    if m == 5 and d in (3, 4, 5):  # Constitution / Greenery / Children
        return True
    if m == 5 and d == 6 and wd == Date.MON:
        return True
    if m == 7 and 14 < d < 22 and y != 2021 and wd == Date.MON:  # Marine Day
        return True
    if m == 7 and d in (22, 23) and y == 2021:  # Olympics
        return True
    if m == 8 and d == 11 and y != 2021:  # Mountain Day
        return True
    if m == 8 and d == 12 and y != 2021 and wd == Date.MON:
        return True
    if m == 8 and d == 9 and y == 2021 and wd == Date.MON:
        return True
    if m == 9 and 14 < d < 22 and wd == Date.MON:  # Respect for the Aged
        return True
    if m == 9 and d == 23:  # Autumnal Equinox (approximate)
        return True
    if m == 9 and d == 24 and wd == Date.MON:
        return True
    if m == 10 and 7 < d <= 14 and y != 2021 and wd == Date.MON:  # Sports
        return True
    if m == 11 and d == 3:  # Culture Day
        return True
    if m == 11 and d == 4 and wd == Date.MON:
        return True
    if m == 11 and d == 23:  # Labour Thanksgiving
        return True
    return False


def _holiday_new_zealand(d, m, y, wd, doy):
    if m == 1 and d == 1:
        return True
    if m == 1 and d in (2, 3) and wd == Date.MON:
        return True
    if m == 1 and 18 < d < 26 and wd == Date.MON:  # Anniversary
        return True
    if m == 2 and d == 6:  # Waitangi Day
        return True
    em = easter_monday_day_of_year(y)
    if doy == em - 3 or doy == em:
        return True
    if m == 4 and d == 25:  # ANZAC
        return True
    if m == 6 and d < 8 and wd == Date.MON:  # Queen's Birthday
        return True
    if m == 10 and 21 < d < 29 and wd == Date.MON:  # Labour Day
        return True
    if m == 12 and d == 25:
        return True
    if m == 12 and d == 26:
        return True
    if m == 12 and d in (26, 27, 28) and wd == Date.MON:
        return True
    return False


def _holiday_norway(d, m, y, wd, doy):
    if m == 1 and d == 1:
        return True
    em = easter_monday_day_of_year(y)
    if doy == em - 4:  # Holy Thursday
        return True
    if doy == em - 3:  # Good Friday
        return True
    if doy == em:
        return True
    if doy == em + 38:  # Ascension
        return True
    if doy == em + 49:  # Pentecost
        return True
    if m == 5 and d == 1:
        return True
    if m == 5 and d == 17:  # Constitution Day
        return True
    if m == 12 and d in (25, 26):
        return True
    return False


def _holiday_sweden(d, m, y, wd, doy):
    if m == 1 and d == 1:
        return True
    if m == 1 and d == 6:  # Epiphany
        return True
    em = easter_monday_day_of_year(y)
    if doy == em - 3 or doy == em:
        return True
    if doy == em + 38:  # Ascension
        return True
    if m == 5 and d == 1:
        return True
    if m == 6 and d == 6:  # National Day
        return True
    if m == 6 and 18 < d < 26 and wd == Date.FRI:  # Midsummer Eve
        return True
    if m == 12 and d in (24, 25, 26, 31):
        return True
    return False


def _holiday_switzerland(d, m, y, wd, doy):
    if m == 1 and d == 1:
        return True
    if m == 1 and d == 2:  # Berchtoldstag
        return True
    em = easter_monday_day_of_year(y)
    if doy == em or doy == em - 3:
        return True
    if doy == em + 38:  # Ascension
        return True
    if doy == em + 49:  # Whit Monday
        return True
    if m == 5 and d == 1:
        return True
    if m == 8 and d == 1:  # National Day
        return True
    if m == 12 and d in (25, 26):
        return True
    return False


_HOLIDAY_RULES = {
    CalendarTypes.NONE: _holiday_none,
    CalendarTypes.WEEKEND: _holiday_weekend,
    CalendarTypes.AUSTRALIA: _holiday_australia,
    CalendarTypes.CANADA: _holiday_canada,
    CalendarTypes.FRANCE: _holiday_france,
    CalendarTypes.GERMANY: _holiday_germany,
    CalendarTypes.ITALY: _holiday_italy,
    CalendarTypes.JAPAN: _holiday_japan,
    CalendarTypes.NEW_ZEALAND: _holiday_new_zealand,
    CalendarTypes.NORWAY: _holiday_norway,
    CalendarTypes.SWEDEN: _holiday_sweden,
    CalendarTypes.SWITZERLAND: _holiday_switzerland,
    CalendarTypes.TARGET: _holiday_target,
    CalendarTypes.UNITED_KINGDOM: _holiday_united_kingdom,
    CalendarTypes.UNITED_STATES: _holiday_united_states,
}


@lru_cache(maxsize=4096)
def _year_business_mask(cal_type: CalendarTypes, year: int):
    """(start_serial, bool mask) of business days for one calendar year."""
    rule = _HOLIDAY_RULES[cal_type]
    start_serial = dmy_to_serial(1, 1, year)
    ndays = 366 if (is_leap_year(year) or year == 1900) else 365
    mask = np.zeros(ndays, dtype=bool)
    serial = start_serial
    for doy in range(1, ndays + 1):
        d, m, y = serial_to_dmy(serial)
        wd = serial_weekday(serial)
        if wd not in (Date.SAT, Date.SUN) and not rule(d, m, y, wd,
                                                       day_of_year(d, m, y)):
            mask[doy - 1] = True
        serial += 1
    return start_serial, mask


class Calendar:
    """Designates dates as holidays per a regional convention and applies
    ISDA business-day adjustments."""

    def __init__(self, cal_type: CalendarTypes, constituent_calendars=None):
        if cal_type not in CalendarTypes:
            raise LibError("Need to pass CalendarTypes and not "
                           + str(cal_type))
        self._cal_type = cal_type
        self._constituent_calendars = constituent_calendars or []

    # ------------------------------------------------------------------

    def adjust(self, dt: Date, bd_type: BusDayAdjustTypes) -> Date:
        """ISDA business-day adjustment of a payment date."""
        if type(bd_type) != BusDayAdjustTypes:
            raise LibError("Invalid adjustment type " + str(bd_type))

        if self._cal_type == CalendarTypes.NONE:
            return dt
        if bd_type == BusDayAdjustTypes.NONE:
            return dt

        if bd_type == BusDayAdjustTypes.FOLLOWING:
            while not self.is_business_day(dt):
                dt = dt.add_days(1)
            return dt

        if bd_type == BusDayAdjustTypes.MODIFIED_FOLLOWING:
            start = dt
            while not self.is_business_day(dt):
                dt = dt.add_days(1)
            if dt.m() != start.m():
                dt = start
                while not self.is_business_day(dt):
                    dt = dt.add_days(-1)
            return dt

        if bd_type == BusDayAdjustTypes.PRECEDING:
            while not self.is_business_day(dt):
                dt = dt.add_days(-1)
            return dt

        if bd_type == BusDayAdjustTypes.MODIFIED_PRECEDING:
            start = dt
            while not self.is_business_day(dt):
                dt = dt.add_days(-1)
            if dt.m() != start.m():
                dt = start
                while not self.is_business_day(dt):
                    dt = dt.add_days(1)
            return dt

        raise LibError("Unknown adjustment convention " + str(bd_type))

    # ------------------------------------------------------------------

    def add_business_days(self, start_dt: Date, num_days: int) -> Date:
        """Step ``num_days`` business days from ``start_dt``."""
        if isinstance(num_days, int) is False:
            raise LibError("Num days must be an integer")
        dt = start_dt
        step = 1 if num_days >= 0 else -1
        remaining = abs(num_days)
        while remaining > 0:
            dt = dt.add_days(step)
            if self.is_business_day(dt):
                remaining -= 1
        return dt

    # ------------------------------------------------------------------

    def is_business_day(self, dt: Date) -> bool:
        if self._cal_type == CalendarTypes.INTERSECTION:
            return all(cal.is_business_day(dt)
                       for cal in self._constituent_calendars)
        if dt.is_weekend():
            return False
        return not self.is_holiday(dt)

    def is_business_serial(self, serial: int) -> bool:
        """Business-day test straight off an Excel serial (cached masks)."""
        if self._cal_type == CalendarTypes.INTERSECTION:
            return all(cal.is_business_serial(serial)
                       for cal in self._constituent_calendars)
        if self._cal_type == CalendarTypes.NONE:
            return True
        _, _, y = serial_to_dmy(serial)
        start, mask = _year_business_mask(self._cal_type, y)
        return bool(mask[serial - start])

    def is_holiday(self, dt: Date) -> bool:
        """True if the date is a bank holiday. Weekends are NOT holidays
        unless the calendar is WEEKEND."""
        if self._cal_type == CalendarTypes.INTERSECTION:
            return any(cal.is_holiday(dt)
                       for cal in self._constituent_calendars)
        rule = _HOLIDAY_RULES.get(self._cal_type)
        if rule is None:
            raise LibError("Unknown calendar " + str(self._cal_type))
        return rule(dt.d(), dt.m(), dt.y(), dt.weekday(), dt.day_of_year())

    # ------------------------------------------------------------------
    # per-region holiday queries (reference calendar.py:328-1103 exposes
    # one method per region on the Calendar class; these delegate to the
    # module-level rule functions regardless of this calendar's own type)

    def _rule_holiday(self, cal_type: CalendarTypes, dt: Date) -> bool:
        return bool(_HOLIDAY_RULES[cal_type](
            dt.d(), dt.m(), dt.y(), dt.weekday(), dt.day_of_year()))

    def holiday_none(self, dt: Date) -> bool:
        return False

    def holiday_weekend(self, dt: Date) -> bool:
        """Weekends by themselves are the holiday."""
        return dt.is_weekend()

    def holiday_australia(self, dt: Date) -> bool:
        return self._rule_holiday(CalendarTypes.AUSTRALIA, dt)

    def holiday_canada(self, dt: Date) -> bool:
        return self._rule_holiday(CalendarTypes.CANADA, dt)

    def holiday_france(self, dt: Date) -> bool:
        return self._rule_holiday(CalendarTypes.FRANCE, dt)

    def holiday_germany(self, dt: Date) -> bool:
        return self._rule_holiday(CalendarTypes.GERMANY, dt)

    def holiday_italy(self, dt: Date) -> bool:
        return self._rule_holiday(CalendarTypes.ITALY, dt)

    def holiday_japan(self, dt: Date) -> bool:
        return self._rule_holiday(CalendarTypes.JAPAN, dt)

    def holiday_new_zealand(self, dt: Date) -> bool:
        return self._rule_holiday(CalendarTypes.NEW_ZEALAND, dt)

    def holiday_norway(self, dt: Date) -> bool:
        return self._rule_holiday(CalendarTypes.NORWAY, dt)

    def holiday_sweden(self, dt: Date) -> bool:
        return self._rule_holiday(CalendarTypes.SWEDEN, dt)

    def holiday_switzerland(self, dt: Date) -> bool:
        return self._rule_holiday(CalendarTypes.SWITZERLAND, dt)

    def holiday_target(self, dt: Date) -> bool:
        return self._rule_holiday(CalendarTypes.TARGET, dt)

    def holiday_united_kingdom(self, dt: Date) -> bool:
        return self._rule_holiday(CalendarTypes.UNITED_KINGDOM, dt)

    def holiday_united_states(self, dt: Date) -> bool:
        return self._rule_holiday(CalendarTypes.UNITED_STATES, dt)

    # ------------------------------------------------------------------

    def get_holiday_list(self, year: int) -> List[str]:
        """All non-weekend holidays in a calendar year, as strings."""
        out = []
        dt = Date(1, 1, year)
        end = Date(1, 1, year + 1)
        while dt < end:
            if not self.is_business_day(dt) and not dt.is_weekend():
                out.append(str(dt))
            dt = dt.add_days(1)
        return out

    def easter_monday(self, year: int) -> Date:
        if year > 2200 or year < 1901:
            raise LibError("Unable to determine Easter Monday in year "
                           + str(year))
        em_doy = easter_monday_day_of_year(year)
        return Date(1, 1, year).add_days(em_doy - 1)

    def holiday_mask(self, start_year: int, end_year: int):
        """Business-day mask over serials [1-Jan-start_year, 31-Dec-end_year].

        Returns (start_serial, numpy bool array). Used by batched schedule
        compilation to vectorize business-day adjustment.
        """
        parts = []
        start_serial = dmy_to_serial(1, 1, start_year)
        if self._cal_type == CalendarTypes.INTERSECTION:
            masks = [cal.holiday_mask(start_year, end_year)[1]
                     for cal in self._constituent_calendars]
            return start_serial, np.logical_and.reduce(masks)
        for y in range(start_year, end_year + 1):
            if self._cal_type == CalendarTypes.NONE:
                n = 366 if (is_leap_year(y) or y == 1900) else 365
                parts.append(np.ones(n, dtype=bool))
            else:
                parts.append(_year_business_mask(self._cal_type, y)[1])
        return start_serial, np.concatenate(parts)

    def __str__(self):
        return self._cal_type.name

    def __repr__(self):
        return str(self._cal_type)


def create_calendar_intersection(*calendars) -> Calendar:
    """Calendar that is a business day only when ALL constituents are."""
    if len(calendars) < 2:
        raise LibError("Need at least 2 calendars to create intersection")
    for cal in calendars:
        if not isinstance(cal, Calendar):
            raise LibError("All arguments must be Calendar objects")
    return Calendar(CalendarTypes.INTERSECTION, list(calendars))
