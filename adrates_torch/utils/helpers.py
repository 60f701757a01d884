"""Formatting, date→time conversion, and validation helpers.

Parity: the reference's cavour/utils/helpers.py — times_from_dates (154-197),
to_tenor (201-242), convert_sensitivities (70-98), label_to_string /
format_table, check_argument_types (618-636), grid_index, dot products.
"""

from __future__ import annotations

import math
from typing import List, Union

import numpy as np

from .date import Date
from .day_count import DayCount, DayCountTypes
from .error import LibError
from .global_vars import gDaysInYear


def times_from_dates(dt: Union[Date, list],
                     value_dt: Date,
                     day_count_type: DayCountTypes = None):
    """Year fractions of date(s) from the valuation date.

    Scalar in → scalar out; list in → numpy vector out (reference contract,
    helpers.py:154-197).
    """
    if isinstance(value_dt, Date) is False:
        raise LibError("Valuation date is not a Date")

    dc_counter = None if day_count_type is None else DayCount(day_count_type)

    def _one(d):
        if dc_counter is None:
            return (d - value_dt) / gDaysInYear
        return dc_counter.year_frac(value_dt, d)[0]

    if isinstance(dt, Date):
        return _one(dt)
    if isinstance(dt, (list, tuple)) and len(dt) > 0 and \
            isinstance(dt[0], Date):
        return np.array([_one(d) for d in dt])
    if isinstance(dt, np.ndarray):
        raise LibError("You passed an ndarray instead of dates.")
    raise LibError("Discount factor must take dates.")


def to_tenor(x: Union[float, List[float]]) -> Union[str, List[str]]:
    """Year fraction(s) → tenor label(s): '<1M'→weeks, '<1Y'→months,
    otherwise 'NY[ MM]' (reference helpers.py:201-242)."""

    def _one(val: float) -> str:
        val = float(val)
        if val < 1 / 12:
            weeks = math.ceil(val * 365 / 7)
            return f"{weeks}W"
        if val < 1:
            months = max(int(round(val * 12)), 1)
            return f"{months}M"
        years = int(math.floor(val))
        rem_months = int(round((val - years) * 12))
        if rem_months == 12:
            years += 1
            rem_months = 0
        return f"{years}Y" if rem_months == 0 else f"{years}Y{rem_months}M"

    if isinstance(x, (list, tuple, np.ndarray)):
        return [_one(v) for v in x]
    return _one(x)


def convert_sensitivities(df_sens: np.ndarray,
                          times: np.ndarray,
                          dfs: np.ndarray) -> np.ndarray:
    """Convert dPV/dDF sensitivities into zero-rate sensitivities.

    dPV/dr_i = dPV/dDF_i * dDF_i/dr_i with DF = exp(-r t) so
    dDF/dr = -t * DF (reference helpers.py:70-98 semantics).
    """
    df_sens = np.asarray(df_sens, dtype=np.float64)
    times = np.asarray(times, dtype=np.float64)
    dfs = np.asarray(dfs, dtype=np.float64)
    return df_sens * (-times) * dfs


def label_to_string(label: str, value, separator: str = "\n",
                    list_format: bool = False) -> str:
    """Fixed-width "LABEL: value" line used by object __repr__s."""
    label = str(label)
    if list_format and isinstance(value, (list, tuple)):
        body = ", ".join(str(v) for v in value)
    else:
        body = str(value)
    return f"{label:<20}: {body}{separator}"


def format_table(header: List[str], rows: List[list]) -> str:
    """Plain-text table (column-aligned) for cashflow/valuation reports."""
    cols = [str(h) for h in header]
    str_rows = [[str(c) for c in row] for row in rows]
    widths = [len(c) for c in cols]
    for row in str_rows:
        for i, cell in enumerate(row):
            widths[i] = max(widths[i], len(cell))
    sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
    out = [sep,
           "|" + "|".join(f" {c:<{w}} " for c, w in zip(cols, widths)) + "|",
           sep]
    for row in str_rows:
        out.append("|" + "|".join(
            f" {c:<{w}} " for c, w in zip(row, widths)) + "|")
    out.append(sep)
    return "\n".join(out)


def table_to_string(title: str, header: List[str], rows: List[list]) -> str:
    return title + "\n" + format_table(header, rows)


def check_argument_types(func, values: dict) -> None:
    """Annotation-driven runtime type check of a function's arguments.

    Tuple annotations mean "any of these types" (reference convention,
    helpers.py:618-636). Unannotated arguments are not checked.
    """
    if func is None:
        return
    annotations = getattr(func, "__annotations__", {})
    for name, expected in annotations.items():
        if name in ("return",) or name not in values:
            continue
        value = values[name]
        if value is None:
            continue
        if isinstance(expected, tuple):
            ok = any(isinstance(value, e) for e in expected
                     if isinstance(e, type))
            if not ok and any(not isinstance(e, type) for e in expected):
                ok = True  # unresolvable annotation: skip
        elif isinstance(expected, type):
            ok = isinstance(value, expected)
        else:
            ok = True  # string/typing annotations: skip
        if not ok:
            raise LibError(
                f"Argument '{name}' of type {type(value).__name__} is not "
                f"of expected type {expected}")


def grid_index(t: float, grid: np.ndarray, tol: float = 1e-8) -> int:
    """Index of t in grid within tolerance, else -1."""
    grid = np.asarray(grid)
    hits = np.where(np.abs(grid - t) < tol)[0]
    return int(hits[0]) if hits.size else -1


def input_time(dt: Date, curve) -> float:
    """Time from a curve's anchor date to dt in years (ACT/gDaysInYear)."""
    if isinstance(dt, Date):
        t = (dt - curve._value_dt) / gDaysInYear
        if t < 0.0:
            raise LibError("Date before curve value date.")
        return t
    raise LibError("Unknown type.")


def dot_product(x, y) -> float:
    return float(np.dot(np.asarray(x), np.asarray(y)))


def check_vector_differences(x, y, tol: float = 1e-6) -> None:
    x = np.asarray(x)
    y = np.asarray(y)
    if x.shape != y.shape:
        raise LibError("Vectors x and y do not have same size.")
    if np.any(np.abs(x - y) > tol):
        raise LibError("Vectors x and y differ by more than tolerance.")


def _func_name() -> str:
    """Name of the calling function (used for type-check plumbing)."""
    import inspect
    return inspect.stack()[1][3]


# ---------------------------------------------------------------------------
# Compat surface for the reference's remaining module-level helpers
# (reference helpers.py:116-640). Host-side conveniences: vectorised
# numpy replaces the reference's numba scalar loops.

def beta_vector_to_corr_matrix(betas) -> np.ndarray:
    """One-factor weights -> correlation matrix, unit diagonal
    (reference helpers.py:116-131)."""
    b = np.asarray(betas, dtype=np.float64)
    corr = np.outer(b, b)
    np.fill_diagonal(corr, 1.0)
    return corr


def pv01_times(t: float, f: float) -> List[float]:
    """Remaining coupon times of a bond with t years to maturity and
    coupon frequency f, in reverse time order (reference
    helpers.py:134-150)."""
    dt = 1.0 / f
    out = []
    while t >= 0.0:
        out.append(t)
        t -= dt
    return out


def check_dt(d) -> None:
    """Raise unless d is a Date (reference helpers.py:268-272)."""
    if not isinstance(d, Date):
        raise LibError("Should be a date dummy!")


def dump(obj) -> None:
    """Print all private then public non-callable attributes of an object
    (reference helpers.py:278-305)."""
    attrs = [a for a in dir(obj)
             if not a.startswith("__") and not callable(getattr(obj, a))]
    print("PRIVATE ATTRIBUTES")
    for a in attrs:
        if a.startswith("_"):
            print(a, getattr(obj, a))
    print("PUBLIC ATTRIBUTES")
    for a in attrs:
        if not a.startswith("_"):
            print(a, getattr(obj, a))


def print_tree(array: np.ndarray, depth: int = None) -> None:
    """Print a binomial/trinomial lattice for debugging (reference
    helpers.py:309-330): columns are time steps, highest node first,
    zeros blanked."""
    array = np.asarray(array)
    n1, n2 = array.shape
    if depth is not None:
        n1 = depth
    for j in range(n2):
        row = array[:n1, n2 - j - 1]
        print("".join(f"{x:10.5f}" if x != 0.0 else " " * 10 for x in row))


def listdiff(a, b) -> List[float]:
    """Elementwise difference of two equal-length vectors (reference
    helpers.py:368-379)."""
    a = np.asarray(a)
    b = np.asarray(b)
    if a.shape != b.shape:
        raise LibError("Cannot diff lists with different sizes")
    return list(a - b)


def dotproduct(x, y) -> float:
    """Alias of dot_product (reference helpers.py:386-394)."""
    return dot_product(x, y)


def frange(start, stop, step) -> list:
    """Inclusive-of-stop arithmetic range (reference helpers.py:401-410)."""
    return list(range(start, stop + 1, step)) if isinstance(start, int) \
        and isinstance(stop, int) and isinstance(step, int) \
        else list(np.arange(start, stop + step * 0.5, step))


def normalise_weights(wt_vector) -> np.ndarray:
    """Normalise weights to sum to 1 (reference helpers.py:417-426)."""
    w = np.asarray(wt_vector, dtype=np.float64)
    return w / np.sum(w)


def to_usable_type(t):
    """Resolve a typing annotation to types usable with isinstance
    (reference helpers.py:508-527)."""
    from typing import Union as _Union, get_args, get_origin
    origin = get_origin(t)
    if origin is list:
        return (list, np.ndarray)
    if origin is dict:
        return dict
    if origin is _Union:
        return tuple(to_usable_type(tp) for tp in get_args(t))
    if t is float:
        return (int, float, np.float64)
    if isinstance(t, tuple):
        return tuple(to_usable_type(tp) for tp in t)
    return t


def accrued_tree(grid_times, grid_flows, face: float) -> np.ndarray:
    """ACT/ACT-style accrued interest at every lattice grid time, linear
    between consecutive coupon times (reference helpers.py:573-613):
    for t in (c_{i-1}, c_i], accrued = face * (t - c_{i-1}) * flow_i /
    (c_i - c_{i-1}); zero at or before the first coupon and after the
    last."""
    from .global_vars import gSmall
    grid_times = np.asarray(grid_times, dtype=np.float64)
    grid_flows = np.asarray(grid_flows, dtype=np.float64)
    if grid_flows.shape != grid_times.shape:
        raise LibError("Grid flows not same size as grid times.")
    mask = grid_flows[1:] > gSmall
    cpn_times = grid_times[1:][mask]
    cpn_flows = grid_flows[1:][mask]
    accrued = np.zeros_like(grid_times)
    if cpn_times.size < 2:
        return accrued
    idx = np.searchsorted(cpn_times, grid_times, side="left")
    in_range = (idx >= 1) & (idx < cpn_times.size)
    i = np.clip(idx, 1, cpn_times.size - 1)
    den = cpn_times[i] - cpn_times[i - 1]
    num = grid_times - cpn_times[i - 1]
    vals = face * num * cpn_flows[i] / np.where(den == 0.0, 1.0, den)
    return np.where(in_range & (num > 0), vals, accrued)
