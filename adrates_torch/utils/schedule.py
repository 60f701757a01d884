"""ISDA coupon schedule generation.

Behavioral parity with the reference's cavour/utils/schedule.py:163-270:
BACKWARD/FORWARD generation, EOM rule, business-day adjustment of interior
dates, optional termination-date adjustment, duplicate removal and
monotonicity check. Long stubs (first_dt / next_to_last_dt) are accepted
but, as in the reference, not yet applied to generation.
"""

from __future__ import annotations

from typing import List

from .calendar import (BusDayAdjustTypes, Calendar, CalendarTypes,
                       DateGenRuleTypes)
from .date import Date
from .error import LibError
from .frequency import FrequencyTypes, annual_frequency


class Schedule:
    """A set of coupon dates generated per ISDA rules. Element 0 is the
    previous coupon date (PCD), element 1 the next coupon date (NCD)."""

    def __init__(self,
                 effective_dt: Date,
                 termination_dt: Date,  # unadjusted unless flag set
                 freq_type: FrequencyTypes = FrequencyTypes.ANNUAL,
                 cal_type: CalendarTypes = CalendarTypes.WEEKEND,
                 bd_type: BusDayAdjustTypes = BusDayAdjustTypes.FOLLOWING,
                 dg_type: DateGenRuleTypes = DateGenRuleTypes.BACKWARD,
                 adjust_termination_dt: bool = True,
                 end_of_month: bool = False,
                 first_dt: Date = None,
                 next_to_last_dt: Date = None):
        if effective_dt >= termination_dt:
            raise LibError("Effective date must be before termination date.")

        self._effective_dt = effective_dt
        self._termination_dt = termination_dt

        if first_dt is None:
            self._first_dt = effective_dt
        else:
            if first_dt > effective_dt and first_dt < termination_dt:
                self._first_dt = first_dt
            else:
                raise LibError("First date must be after effective date and"
                               " before termination date")

        if next_to_last_dt is None:
            self._next_to_last_dt = termination_dt
        else:
            if (next_to_last_dt > effective_dt
                    and next_to_last_dt < termination_dt):
                self._next_to_last_dt = next_to_last_dt
            else:
                raise LibError("Next to last date must be after effective "
                               "date and before termination date")

        self._freq_type = freq_type
        self._cal_type = cal_type
        self._bd_type = bd_type
        self._dg_type = dg_type
        self._adjust_termination_dt = adjust_termination_dt
        self._end_of_month = bool(end_of_month)
        self._adjusted_dts: List[Date] = None

        self.generate()

    # ------------------------------------------------------------------

    def schedule_dts(self) -> List[Date]:
        if self._adjusted_dts is None:
            self.generate()
        return self._adjusted_dts

    # ------------------------------------------------------------------

    def generate(self) -> List[Date]:
        """Generate and adjust the coupon dates."""
        calendar = Calendar(self._cal_type)
        frequency = annual_frequency(self._freq_type)
        num_months = int(12 / frequency)

        self._adjusted_dts = []

        if self._dg_type == DateGenRuleTypes.BACKWARD:
            # Unadjusted dates stepping back from termination.
            unadjusted = []
            next_dt = self._termination_dt
            flow_num = 0
            while next_dt > self._effective_dt:
                unadjusted.append(next_dt)
                next_dt = self._termination_dt.add_months(
                    -num_months * (1 + flow_num))
                if self._end_of_month:
                    next_dt = next_dt.eom()
                flow_num += 1
            unadjusted.append(next_dt)  # previous coupon date
            flow_num += 1

            # First (earliest) date is kept unadjusted.
            self._adjusted_dts.append(unadjusted[flow_num - 1])
            # Interior dates are business-day adjusted.
            for i in range(1, flow_num - 1):
                self._adjusted_dts.append(
                    calendar.adjust(unadjusted[flow_num - i - 1],
                                    self._bd_type))
            self._adjusted_dts.append(self._termination_dt)

        elif self._dg_type == DateGenRuleTypes.FORWARD:
            unadjusted = [self._effective_dt]
            next_dt = self._effective_dt
            flow_num = 1
            while next_dt < self._termination_dt:
                unadjusted.append(next_dt)
                next_dt = self._effective_dt.add_months(
                    num_months * flow_num)
                flow_num += 1
            for i in range(1, flow_num):
                self._adjusted_dts.append(
                    calendar.adjust(unadjusted[i], self._bd_type))
            self._adjusted_dts.append(self._termination_dt)

        if self._adjusted_dts[0] < self._effective_dt:
            self._adjusted_dts[0] = self._effective_dt

        # Swaps leave the termination date unadjusted unless contractually
        # stated; CDS adjust it. Controlled by the flag (reference behavior).
        if self._adjust_termination_dt:
            self._termination_dt = calendar.adjust(self._termination_dt,
                                                   self._bd_type)
            self._adjusted_dts[-1] = self._termination_dt

        if len(self._adjusted_dts) < 2:
            raise LibError("Schedule has two dates only.")

        # De-duplicate equal adjacent dates and enforce monotonicity.
        prev_dt = self._adjusted_dts[0]
        for dt in self._adjusted_dts[1:]:
            if dt == prev_dt:
                self._adjusted_dts.pop(0)
            if dt < prev_dt:
                raise LibError("Dates are not monotonic")
            prev_dt = dt

        return self._adjusted_dts

    # ------------------------------------------------------------------

    def __repr__(self):
        lines = [f"OBJECT TYPE: {type(self).__name__}",
                 f"EFFECTIVE DATE: {self._effective_dt}",
                 f"END DATE: {self._termination_dt}",
                 f"FREQUENCY: {self._freq_type}",
                 f"CALENDAR: {self._cal_type}",
                 f"BUSDAYRULE: {self._bd_type}",
                 f"DATEGENRULE: {self._dg_type}",
                 f"ADJUST TERM DATE: {self._adjust_termination_dt}",
                 f"END OF MONTH: {self._end_of_month}"]
        return "\n".join(lines)

    def _print(self):
        print(self)
