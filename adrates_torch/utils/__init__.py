"""Convention-layer utilities (dates, calendars, day counts, schedules,
enums). Everything here runs at trade-compile time in plain
Python/numpy; none of it touches torch."""

from .error import LibError
from .global_vars import gDaysInYear, gSmall, g_small
from .currency import CurrencyTypes
from .frequency import FrequencyTypes, annual_frequency
from .date import (Date, DateFormatTypes, set_date_format, is_leap_year,
                   days_in_month, day_of_year, dmy_to_serial, serial_to_dmy,
                   serial_weekday, date_range, datediff, serials_from_dates,
                   vectorisation_helper)
from .calendar import (BusDayAdjustTypes, Calendar, CalendarTypes,
                       DateGenRuleTypes, create_calendar_intersection,
                       easter_monday_day_of_year, easter_sunday_day_of_year)
from .day_count import DayCount, DayCountTypes, is_last_day_of_feb
from .schedule import Schedule
from .global_types import (SwapTypes, InstrumentTypes, RequestTypes,
                           InterpTypes, CurveTypes, InflationIndexTypes,
                           InflationInterpTypes, CollateralType,
                           collateral_to_currency, is_currency_collateral,
                           is_bond_collateral, get_discount_curve_name)
from .helpers import (times_from_dates, to_tenor, convert_sensitivities,
                      label_to_string, format_table, table_to_string,
                      check_argument_types, grid_index, input_time,
                      dot_product, check_vector_differences, _func_name)

ONE_MILLION = 1_000_000
from .observability import configure as configure_logging, metrics, timed
