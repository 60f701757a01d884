"""Discount curve: a (times, dfs) grid plus DF queries.

Port of the part of ``adrates_tpu/market/curves/discount_curve.py`` that
``OISCurve`` needs: the grid lives on the host as CPU float64 tensors
and every query goes through a static interpolation plan
(``ops/interpolation.simple_df_static``), the same evaluation the book
path uses. The rate queries (zero/swap/forward rates, bumps) are not
ported yet.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from ...ops.interpolation import (plan_to_torch, simple_df_static,
                                  simple_interp_plan)
from ...utils.date import Date
from ...utils.day_count import DayCountTypes
from ...utils.helpers import label_to_string, times_from_dates


class DiscountCurve:
    """Base discount curve anchored at (t=0, df=1). Subclasses set
    ``_value_dt``, ``_interp_type``, ``_times`` and ``_dfs`` ([P1] CPU
    float64 tensors, t=0 node included)."""

    def value_dt(self) -> Date:
        return self._value_dt

    def df_t(self, t) -> torch.Tensor:
        """DF at time(s) in years (host float64 tensor)."""
        q = np.atleast_1d(np.asarray(t, dtype=np.float64))
        plan = plan_to_torch(simple_interp_plan(
            q, self._times.numpy(), self._interp_type), "cpu")
        return simple_df_static(plan, self._dfs, self._interp_type)

    def df(self, dt: Union[Date, list],
           day_count: DayCountTypes = DayCountTypes.ACT_ACT_ISDA):
        """DF at date(s); dates convert to times under ``day_count``."""
        times = times_from_dates(dt, self._value_dt, day_count)
        dfs = self.df_t(times).numpy()
        if isinstance(dt, Date):
            return float(dfs[0])
        return dfs

    def __repr__(self):
        s = label_to_string("OBJECT TYPE", type(self).__name__)
        s += label_to_string("DATES", "DISCOUNT FACTORS")
        for t, df in zip(self._times.tolist(), self._dfs.tolist()):
            s += label_to_string(f"{t:12.8f}", f"{df:12.8f}")
        return s
