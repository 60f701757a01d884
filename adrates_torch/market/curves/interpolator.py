"""Interpolator API surface: module-level legacy functions + fit/eval classes.

Port of ``adrates_tpu/market/curves/interpolator.py`` (API parity with
the reference's interpolator.py: interpolate/_uinterpolate/_vinterpolate
and the Interpolator class; interpolator_ad.py's InterpolatorAd). The
classes evaluate through ``ops/interpolation.py``, the one stack every
consumer of the port shares; the module-level functions keep the
reference's legacy closed forms (host numpy) for their users.
"""

from __future__ import annotations

import numpy as np
import torch

from ...ops.interpolation import InterpAux, interp_df, interp_fit, simple_df
from ...utils.error import LibError
from ...utils.global_types import InterpTypes


def _uinterpolate(t: float, times, dfs, method: int) -> float:
    """Scalar legacy interpolation (closed forms, numpy): index scan,
    per-scheme closed forms, linear extrapolation in transform space
    beyond the last knot (reference interpolator.py:69-170)."""
    times = np.asarray(times, dtype=float)
    dfs = np.asarray(dfs, dtype=float)
    small = 1e-10
    num_points = times.size

    if t == times[0]:
        return float(dfs[0])

    i = 0
    while i < num_points - 1 and times[i] < t:
        i += 1
    if t > times[i]:
        i = num_points

    if method == InterpTypes.LINEAR_ZERO_RATES.value:
        if i == 1:
            r1 = -np.log(dfs[i]) / times[i]
            r2 = r1
            dt = times[i] - times[i - 1]
            rvalue = ((times[i] - t) * r1 + (t - times[i - 1]) * r2) / dt
            return float(np.exp(-rvalue * t))
        if i < num_points:
            r1 = -np.log(dfs[i - 1]) / times[i - 1]
            r2 = -np.log(dfs[i]) / times[i]
            dt = times[i] - times[i - 1]
            rvalue = ((times[i] - t) * r1 + (t - times[i - 1]) * r2) / dt
            return float(np.exp(-rvalue * t))
        r1 = -np.log(dfs[i - 1]) / times[i - 1]
        r2 = r1
        dt = times[i - 1] - times[i - 2]
        rvalue = ((times[i - 1] - t) * r1 + (t - times[i - 2]) * r2) / dt
        return float(np.exp(-rvalue * t))

    if method == InterpTypes.FLAT_FWD_RATES.value:
        if i == 1 or i < num_points:
            rt1 = -np.log(dfs[i - 1])
            rt2 = -np.log(dfs[i])
            dt = times[i] - times[i - 1]
            rtvalue = ((times[i] - t) * rt1 + (t - times[i - 1]) * rt2) / dt
            return float(np.exp(-rtvalue))
        rt1 = -np.log(dfs[i - 2])
        rt2 = -np.log(dfs[i - 1])
        dt = times[i - 1] - times[i - 2]
        rtvalue = ((times[i - 1] - t) * rt1 + (t - times[i - 2]) * rt2) / dt
        return float(np.exp(-rtvalue))

    if method == InterpTypes.LINEAR_FWD_RATES.value:
        if i == 1:
            y2 = -np.log(dfs[i] + small)
            yvalue = t * y2 / (times[i] + small)
            return float(np.exp(-yvalue))
        if i < num_points:
            fwd1 = -np.log(dfs[i - 1] / dfs[i - 2]) / \
                (times[i - 1] - times[i - 2])
            fwd2 = -np.log(dfs[i] / dfs[i - 1]) / (times[i] - times[i - 1])
            dt = times[i] - times[i - 1]
            fwd = ((times[i] - t) * fwd1 + (t - times[i - 1]) * fwd2) / dt
            return float(dfs[i - 1] * np.exp(-fwd * (t - times[i - 1])))
        fwd = -np.log(dfs[i - 1] / dfs[i - 2]) / \
            (times[i - 1] - times[i - 2])
        return float(dfs[i - 1] * np.exp(-fwd * (t - times[i - 1])))

    raise LibError("Invalid interpolation scheme.")


def _vinterpolate(xValues, xvector, dfs, method: int) -> np.ndarray:
    """Vector legacy interpolation."""
    xValues = np.atleast_1d(np.asarray(xValues, dtype=float))
    return np.array([_uinterpolate(float(x), xvector, dfs, method)
                     for x in xValues])


def interpolate(t, times, dfs, method: int):
    """Module-level dispatch (legacy API, interpolator.py:35-61)."""
    if isinstance(t, (float, int)):
        if t < 0.0:
            raise LibError("Interpolate times must all be >= 0")
        return _uinterpolate(float(t), times, dfs, method)
    t_arr = np.asarray(t, dtype=float)
    if np.any(t_arr < 0.0):
        raise LibError("Interpolate times must all be >= 0")
    return _vinterpolate(t_arr, times, dfs, method)


def _f64(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


class Interpolator:
    """fit/interpolate wrapper over ``ops/interpolation.py`` (API parity
    with the reference's scipy-backed class, interpolator.py:210-539);
    host float64 tensors in and out."""

    def __init__(self, interpolator_type: InterpTypes):
        self._interp_type = interpolator_type
        self._times = None
        self._dfs = None
        self._aux: InterpAux = None

    def fit(self, times, dfs):
        self._times = _f64(times)
        self._dfs = _f64(dfs)
        self._aux = interp_fit(self._times, self._dfs, self._interp_type)

    def interpolate(self, t):
        if self._dfs is None:
            raise LibError("Dfs have not been set.")
        return interp_df(t, self._times, self._dfs, self._interp_type,
                         self._aux)

    def simple_interpolate(self, t, times, dfs, method: int):
        """Stateless scalar-scheme interpolation (reference
        interpolator.py:424-454 / interpolator_ad.py:187-249)."""
        return simple_df(t, _f64(times), _f64(dfs), InterpTypes(method))


class InterpolatorAd(Interpolator):
    """AD-stack interpolator (the same kernels; a distinct name for API
    parity with interpolator_ad.py)."""
