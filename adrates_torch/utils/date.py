"""Date handling with Excel-1900 serial-number compatibility.

Immutable ``Date`` class whose internal representation is the Excel serial
day number (1 = 1 Jan 1900), deliberately including the Lotus-1-2-3 1900
leap-year bug: Excel believes 29 Feb 1900 existed, so every date from
1 Mar 1900 onward carries a +1 offset relative to the true day count.

Behavioral parity with the reference's cavour/utils/date.py (Date semantics:
serial numbering date.py:134-206, weekday date.py:213-216, add_months day
clamping date.py:596-652, add_tenor day-of-month restoration date.py:796-879,
IMM/CDS dates date.py:697-788). The implementation here is closed-form
(no padded lookup tables, no per-day stepping loops) so that large schedules
compile to O(1) arithmetic per date.
"""

from __future__ import annotations

import datetime
import math
from enum import Enum
from functools import lru_cache
from typing import Iterable, List, Union

import numpy as np

from .error import LibError


class DateFormatTypes(Enum):
    BLOOMBERG = 1
    US_SHORT = 2
    US_MEDIUM = 3
    US_LONG = 4
    US_LONGEST = 5
    UK_SHORT = 6
    UK_MEDIUM = 7
    UK_LONG = 8
    UK_LONGEST = 9
    DATETIME = 10


g_date_type_format = DateFormatTypes.UK_LONG


def set_date_format(format_type: DateFormatTypes) -> None:
    """Set the global date display format."""
    global g_date_type_format
    g_date_type_format = format_type


short_day_names = ["MON", "TUE", "WED", "THU", "FRI", "SAT", "SUN"]
long_day_names = ["MONDAY", "TUESDAY", "WEDNESDAY", "THURSDAY", "FRIDAY",
                  "SATURDAY", "SUNDAY"]
short_month_names = ["JAN", "FEB", "MAR", "APR", "MAY", "JUN",
                     "JUL", "AUG", "SEP", "OCT", "NOV", "DEC"]
long_month_names = ["JANUARY", "FEBRUARY", "MARCH", "APRIL", "MAY", "JUNE",
                    "JULY", "AUGUST", "SEPTEMBER", "OCTOBER", "NOVEMBER",
                    "DECEMBER"]

month_days_not_leap_year = [31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31]
month_days_leap_year = [31, 29, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31]

# Cumulative days before the start of each month (non-leap), index 0 = Jan.
_CUM_DAYS_NOT_LEAP = [0, 31, 59, 90, 120, 151, 181, 212, 243, 273, 304, 334]

_EXCEL_EPOCH = datetime.date(1900, 1, 1)  # serial 1
_FAKE_LEAP_CUTOVER = 60  # serial of the fictitious 29 Feb 1900 in Excel


def is_leap_year(y: int) -> bool:
    """True if ``y`` is a (real, Gregorian) leap year."""
    return (y % 4 == 0 and y % 100 != 0) or (y % 400 == 0)


def days_in_month(m: int, y: int) -> int:
    """Number of days in calendar month ``m`` of year ``y``."""
    if is_leap_year(y):
        return month_days_leap_year[m - 1]
    return month_days_not_leap_year[m - 1]


def day_of_year(d: int, m: int, y: int) -> int:
    """1-based day-of-year of a (real) calendar date."""
    doy = _CUM_DAYS_NOT_LEAP[m - 1] + d
    if m > 2 and is_leap_year(y):
        doy += 1
    return doy


def dmy_to_serial(d: int, m: int, y: int) -> int:
    """Closed-form Excel serial (1 Jan 1900 = 1, with the fake 29 Feb 1900).

    For dates on/after 1 Mar 1900 the serial is (true day offset from
    1 Jan 1900) + 2; before that it is offset + 1.
    """
    true_offset = (datetime.date(y, m, d) - _EXCEL_EPOCH).days
    serial = true_offset + 1
    if serial >= _FAKE_LEAP_CUTOVER:
        serial += 1
    return serial


def serial_to_dmy(serial: int):
    """Inverse of :func:`dmy_to_serial`. The fake serial 60 maps to 1 Mar
    1900 (Excel displays 29 Feb 1900; we never construct that date)."""
    if serial > _FAKE_LEAP_CUTOVER:
        serial -= 1
    dt = _EXCEL_EPOCH + datetime.timedelta(days=serial - 1)
    return dt.day, dt.month, dt.year


def serial_weekday(serial: int) -> int:
    """Excel-compatible weekday from a serial: MON=0 .. SUN=6.

    Inherits the Excel 1900 bug for serials before 1 Mar 1900 (parity with
    reference date.py:213-216: weekday = (serial + 5) % 7).
    """
    return (serial + 5) % 7


def _parse_tenor(tenor_str: str):
    """Parse a tenor string into (unit, n). unit in {'D','W','M','Y'}."""
    t = tenor_str.upper()
    if t in ("ON", "TN"):
        return "D", 1
    unit = t[-1]
    if unit not in ("D", "W", "M", "Y"):
        raise LibError("Unknown tenor type in " + tenor_str)
    try:
        n = int(t[:-1])
    except ValueError:
        raise LibError("Invalid tenor string " + tenor_str)
    return unit, n


def vectorisation_helper(func):
    """Map a binary Date operator elementwise when `other` is iterable,
    preserving the container type (parity: reference date.py:221-229)."""

    def wrapper(self_, other):
        if isinstance(other, Iterable):
            output_type = type(other)
            return output_type(func(self_, o) for o in other)
        return func(self_, other)

    return wrapper


class Date:
    """An immutable calendar date keyed on the Excel-1900 serial number."""

    MON = 0
    TUE = 1
    WED = 2
    THU = 3
    FRI = 4
    SAT = 5
    SUN = 6

    __slots__ = ("_d", "_m", "_y", "_hh", "_mm", "_ss", "_excel_dt",
                 "_weekday")

    def __init__(self, d: int, m: int, y: int, hh: int = 0, mm: int = 0,
                 ss: int = 0):
        if d >= 1900 and y > 0 and y <= 31:
            raise LibError(
                "Date arguments must be in the order Date(dd, mm, yyyy)")
        if y < 1900:
            raise LibError("Year cannot be before 1900")
        if m < 1 or m > 12:
            raise LibError("Month must be in range 1-12")
        if d < 1 or d > days_in_month(m, y):
            raise LibError("Day not valid for month/year")
        if hh < 0 or hh > 23:
            raise LibError("Hours must be in range 0-23")
        if mm < 0 or mm > 59:
            raise LibError("Minutes must be in range 0-59")
        if ss < 0 or ss > 59:
            raise LibError("Seconds must be in range 0-59")

        object.__setattr__(self, "_d", d)
        object.__setattr__(self, "_m", m)
        object.__setattr__(self, "_y", y)
        object.__setattr__(self, "_hh", hh)
        object.__setattr__(self, "_mm", mm)
        object.__setattr__(self, "_ss", ss)

        serial = dmy_to_serial(d, m, y)
        day_fraction = hh / 24.0 + mm / 1440.0 + ss / 86400.0
        object.__setattr__(self, "_excel_dt", serial + day_fraction)
        object.__setattr__(self, "_weekday", serial_weekday(serial))

    def __setattr__(self, *args):
        raise LibError("Date objects are immutable")

    # ------------------------------------------------------------------
    # accessors
    # ------------------------------------------------------------------

    def d(self) -> int:
        return self._d

    def m(self) -> int:
        return self._m

    def y(self) -> int:
        return self._y

    def excel_dt(self):
        return self._excel_dt

    def serial(self) -> int:
        """Integer Excel serial (drops intraday fraction)."""
        return int(self._excel_dt)

    def weekday(self) -> int:
        return self._weekday

    def day_of_year(self) -> int:
        return day_of_year(self._d, self._m, self._y)

    # ------------------------------------------------------------------
    # constructors
    # ------------------------------------------------------------------

    @classmethod
    def from_string(cls, date_string: str, format_string: str) -> "Date":
        dt = datetime.datetime.strptime(date_string, format_string)
        return cls(dt.day, dt.month, dt.year)

    @classmethod
    def from_date(cls, date) -> "Date":
        if isinstance(date, np.datetime64):
            ts = (date - np.datetime64("1970-01-01T00:00:00")) \
                / np.timedelta64(1, "s")
            date = datetime.datetime.utcfromtimestamp(float(ts))
        if isinstance(date, (datetime.date, datetime.datetime)):
            return cls(date.day, date.month, date.year)
        raise LibError("Cannot create Date from " + str(type(date)))

    @classmethod
    def from_serial(cls, serial: int) -> "Date":
        d, m, y = serial_to_dmy(int(serial))
        return cls(d, m, y)

    # ------------------------------------------------------------------
    # comparisons / arithmetic (vectorised over iterables of Dates)
    # ------------------------------------------------------------------

    @vectorisation_helper
    def __gt__(self, other):
        return self._excel_dt > other._excel_dt

    @vectorisation_helper
    def __lt__(self, other):
        return self._excel_dt < other._excel_dt

    @vectorisation_helper
    def __ge__(self, other):
        return self._excel_dt >= other._excel_dt

    @vectorisation_helper
    def __le__(self, other):
        return self._excel_dt <= other._excel_dt

    @vectorisation_helper
    def __sub__(self, other):
        return self._excel_dt - other._excel_dt

    @vectorisation_helper
    def __rsub__(self, other):
        return self._excel_dt - other._excel_dt

    @vectorisation_helper
    def __eq__(self, other):
        return isinstance(other, Date) and self._excel_dt == other._excel_dt

    def __hash__(self):
        return hash(self._excel_dt)

    # ------------------------------------------------------------------
    # predicates
    # ------------------------------------------------------------------

    def is_weekend(self) -> bool:
        return self._weekday in (Date.SAT, Date.SUN)

    def is_eom(self) -> bool:
        return self._d == days_in_month(self._m, self._y)

    def eom(self) -> "Date":
        return Date(days_in_month(self._m, self._y), self._m, self._y)

    # ------------------------------------------------------------------
    # arithmetic
    # ------------------------------------------------------------------

    def add_days(self, num_days: int = 1) -> "Date":
        return Date.from_serial(self.serial() + int(num_days))

    def add_hours(self, hours: int) -> "Date":
        """A new date ``hours`` later, rolling into following days
        (parity: reference date.py:487-505; negative hours rejected
        there too)."""
        if hours < 0:
            raise LibError("Number of hours must be positive")
        total = self._hh + int(hours)
        dt = self.add_days(total // 24)
        return Date(dt._d, dt._m, dt._y, hh=total % 24, mm=self._mm,
                    ss=self._ss)

    def add_weekdays(self, num_days: int) -> "Date":
        """Add ``num_days`` weekdays (weekends skipped; holidays ignored).

        Closed-form week arithmetic on the serial — O(1) per call, matching
        the reference's day-stepping loop (date.py:529-592) exactly.
        """
        if isinstance(num_days, int) is False:
            raise LibError("Num days must be an integer")
        serial = self.serial()
        step = 1 if num_days >= 0 else -1
        remaining = abs(num_days)
        wd = serial_weekday(serial)
        # Move to a weekday baseline first if starting on a weekend.
        while remaining > 0:
            serial += step
            wd = serial_weekday(serial)
            if wd not in (Date.SAT, Date.SUN):
                remaining -= 1
        return Date.from_serial(serial)

    def add_months(self, mm: Union[int, float, list]) -> "Date":
        """Add calendar months, clamping the day to month end."""
        scalar = isinstance(mm, (int, float))
        mm_vector = [mm] if scalar else mm
        out = []
        for mmi in mm_vector:
            if int(mmi) != mmi:
                raise LibError("Must only pass integers or float integers.")
            mmi = int(mmi)
            m = self._m + mmi
            y = self._y
            while m > 12:
                m -= 12
                y += 1
            while m < 1:
                m += 12
                y -= 1
            d = min(self._d, days_in_month(m, y))
            out.append(Date(d, m, y))
        return out[0] if scalar else out

    def add_years(self, yy: Union[int, float, list]) -> "Date":
        """Add (possibly fractional) years; fractional part converted to
        days using the mean month length (parity: date.py:657-692)."""
        scalar = isinstance(yy, (int, float))
        yy_vector = [yy] if scalar else yy
        out = []
        for yyi in yy_vector:
            days_in_mo = 365.242 / 12.0
            mmi = int(yyi * 12.0)
            ddi = int((yyi * 12.0 - mmi) * days_in_mo)
            new_dt = self.add_months(mmi).add_days(ddi)
            out.append(new_dt)
        return out[0] if scalar else out

    def add_tenor(self, tenor: Union[str, list]) -> "Date":
        """Advance by a tenor string ("1D/2W/3M/10Y/ON/TN", case-insensitive).

        Month tenors restore the original day-of-month if the intermediate
        clamping lost it (parity: reference date.py:855-864). Unadjusted for
        calendars — business-day adjustment happens afterwards.
        """
        list_flag = isinstance(tenor, list)
        tenors = tenor if list_flag else [tenor]
        out = []
        for ten in tenors:
            if not isinstance(ten, str):
                raise LibError("Tenor must be a string e.g. '5Y'")
            unit, n = _parse_tenor(ten)
            sign = 1 if n >= 0 else -1
            if unit == "D":
                new_dt = self.add_days(n)
            elif unit == "W":
                new_dt = self.add_days(7 * n)
            elif unit == "M":
                new_dt = self.add_months(n)
                d = min(self._d, new_dt.eom()._d)
                new_dt = Date(d, new_dt._m, new_dt._y)
            else:  # Y
                new_dt = self.add_months(12 * n)
                d = min(self._d, new_dt.eom()._d)
                new_dt = Date(d, new_dt._m, new_dt._y)
            out.append(new_dt)
        return out if list_flag else out[0]

    # ------------------------------------------------------------------
    # market dates
    # ------------------------------------------------------------------

    def third_wednesday_of_month(self, m: int, y: int) -> int:
        for d in range(15, 22):
            if Date(d, m, y).weekday() == Date.WED:
                return d
        raise LibError("Third Wednesday not found")

    def next_imm_date(self) -> "Date":
        """Next IMM date (3rd Wednesday of Mar/Jun/Sep/Dec) strictly
        following, per the reference rules (date.py:752-788)."""
        y, m, d = self._y, self._m, self._d
        y_imm = y
        if m == 12 and d >= self.third_wednesday_of_month(m, y):
            m_imm, y_imm = 3, y + 1
        elif m in (10, 11, 12):
            m_imm = 12
        elif m == 9 and d >= self.third_wednesday_of_month(m, y):
            m_imm = 12
        elif m in (7, 8, 9):
            m_imm = 9
        elif m == 6 and d >= self.third_wednesday_of_month(m, y):
            m_imm = 9
        elif m in (4, 5, 6):
            m_imm = 6
        elif m == 3 and d >= self.third_wednesday_of_month(m, y):
            m_imm = 6
        else:
            m_imm = 3
        d_imm = self.third_wednesday_of_month(m_imm, y_imm)
        return Date(d_imm, m_imm, y_imm)

    def next_cds_date(self, mm: int = 0) -> "Date":
        """Next CDS roll date (20th of Mar/Jun/Sep/Dec) on/after this date
        advanced by ``mm`` months (parity: date.py:697-733)."""
        next_dt = self.add_months(mm)
        y, m, d = next_dt.y(), next_dt.m(), next_dt.d()
        y_cds = y
        if m == 12 and d >= 20:
            m_cds, y_cds = 3, y + 1
        elif m in (10, 11, 12):
            m_cds = 12
        elif m == 9 and d >= 20:
            m_cds = 12
        elif m in (7, 8, 9):
            m_cds = 9
        elif m == 6 and d >= 20:
            m_cds = 9
        elif m in (4, 5, 6):
            m_cds = 6
        elif m == 3 and d >= 20:
            m_cds = 6
        else:
            m_cds = 3
        return Date(20, m_cds, y_cds)

    # ------------------------------------------------------------------
    # formatting
    # ------------------------------------------------------------------

    def datetime(self) -> datetime.date:
        return datetime.date(self._y, self._m, self._d)

    def str(self) -> str:
        return self.__str__()

    def __str__(self):
        fmt = g_date_type_format
        day = f"{self._d:02d}"
        if fmt == DateFormatTypes.UK_LONGEST:
            return (f"{long_day_names[self._weekday]} {day} "
                    f"{long_month_names[self._m - 1]} {self._y}")
        if fmt == DateFormatTypes.UK_LONG:
            return f"{day}-{short_month_names[self._m - 1]}-{self._y}"
        if fmt == DateFormatTypes.UK_MEDIUM:
            return f"{day}/{self._m:02d}/{self._y}"
        if fmt == DateFormatTypes.UK_SHORT:
            return f"{day}/{self._m:02d}/{self._y % 100:02d}"
        if fmt == DateFormatTypes.US_LONGEST:
            return (f"{long_day_names[self._weekday]} "
                    f"{long_month_names[self._m - 1]} {day} {self._y}")
        if fmt == DateFormatTypes.US_LONG:
            return f"{short_month_names[self._m - 1]}-{day}-{self._y}"
        if fmt == DateFormatTypes.US_MEDIUM:
            return f"{self._m:02d}/{day}/{self._y}"
        if fmt == DateFormatTypes.US_SHORT:
            return f"{self._m:02d}/{day}/{self._y % 100:02d}"
        if fmt == DateFormatTypes.BLOOMBERG:
            return f"{self._m}/{self._d}/{self._y % 100:02d}"
        if fmt == DateFormatTypes.DATETIME:
            return f"{day}/{self._m:02d}/{self._y} 00:00:00"
        raise LibError("Unknown date format")

    def __repr__(self):
        return self.__str__()


def date_range(start_dt: Date, end_dt: Date, tenor: str = "1D") -> List[Date]:
    """Inclusive list of dates from start to end stepping by tenor
    (parity: reference date.py date_range)."""
    if start_dt > end_dt:
        return []
    out = []
    dt = start_dt
    while dt <= end_dt:
        out.append(dt)
        dt = dt.add_tenor(tenor)
    return out


def datediff(d1: Date, d2: Date) -> int:
    """Day count d2 - d1 in Excel serial space."""
    return int(d2._excel_dt - d1._excel_dt)


def serials_from_dates(dates: List[Date]) -> np.ndarray:
    """Vector of integer serials for a list of Dates."""
    return np.array([dt.serial() for dt in dates], dtype=np.int64)


# ---------------------------------------------------------------------------
# Compat surface for the reference's remaining date module functions
# (reference date.py:123-1110). The reference keeps a numba-built padded
# lookup table (calculate_list / g_dt_counter_list); this build's Date is
# already closed-form over Excel serials, so the index mapping is pure
# arithmetic.

_G_START_YEAR = 1900
# reference-exported module globals (date.py:92-135; the camelCase name
# is the reference's own public spelling)
g_start_year = 1900
g_end_year = 2100
longMonthNames = ["JANUARY", "FEBRUARY", "MARCH", "APRIL", "MAY", "JUNE",
                  "JULY", "AUGUST", "SEPTEMBER", "OCTOBER", "NOVEMBER",
                  "DECEMBER"]
g_dt_counter_list = None


def calculate_list() -> None:
    """Populate ``g_dt_counter_list``: Excel day counts (1900 Lotus leap
    bug included) on the 31-days-per-month padded grid, -999 at invalid
    slots (reference date.py:137-181). This build's Date works from
    closed-form serials, so the table exists purely for API parity."""
    global g_dt_counter_list
    out = []
    day_counter = 0
    for yy in range(g_start_year, g_end_year + 1):
        leap = True if yy == 1900 else is_leap_year(yy)
        days_in = month_days_leap_year if leap else month_days_not_leap_year
        for mm in range(1, 13):
            max_days = days_in[mm - 1]
            for _ in range(max_days):
                day_counter += 1
                out.append(day_counter)
            out.extend([-999] * (31 - max_days))
    g_dt_counter_list = out


def test_type() -> None:
    """Print the active global date format (reference date.py:1098-1100)."""
    print("TEST TYPE", g_date_type_format)


def parse_dt(date_str: str, date_format: str):
    """Parse a date string into (day, month, year) (reference
    date.py:123-125)."""
    import datetime as _datetime
    obj = _datetime.datetime.strptime(date_str, date_format)
    return obj.day, obj.month, obj.year


def from_datetime(dt) -> Date:
    """Date from a datetime/date-like object with day/month/year
    attributes (reference date.py:1051-1056)."""
    return Date(dt.day, dt.month, dt.year)


def weekday(day_count: int) -> int:
    """Excel serial day count -> weekday index (reference date.py:213-216
    convention: (serial + 5) % 7)."""
    return (int(day_count) + 5) % 7


def date_index(d: int, m: int, y: int) -> int:
    """Index of a date in the reference's 31-days-per-month padded grid
    (reference date.py:192-196)."""
    return (y - _G_START_YEAR) * 12 * 31 + (m - 1) * 31 + (d - 1)


def date_from_index(idx: int):
    """Inverse of date_index (reference date.py:201-208)."""
    idx = int(idx)
    y = _G_START_YEAR + idx // (12 * 31)
    rem = idx - (y - _G_START_YEAR) * 12 * 31
    m = 1 + rem // 31
    d = 1 + rem - (m - 1) * 31
    return (d, m, y)


def daily_working_day_schedule(start_dt: Date, end_dt: Date) -> List[Date]:
    """Weekday dates from start_dt stepping one weekday at a time until
    end_dt is reached (reference date.py:1024-1037: start date included
    as given, even if itself a weekend)."""
    out = [start_dt]
    dt = start_dt
    while dt < end_dt:
        dt = dt.add_weekdays(1)
        out.append(dt)
    return out
