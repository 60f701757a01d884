"""Result-class foundations: base ABC + capability mixins.

Parity: the reference's cavour/requests/results_base.py:22-376 (BaseResult,
ArithmeticMixin, ExportMixin, VisualizationMixin, AggregationMixin,
ValidationMixin).
"""

from __future__ import annotations

import json
from abc import ABC, abstractmethod
from typing import Any, Dict, Optional

import numpy as np


class BaseResult(ABC):
    """Abstract base for all analytics result containers."""

    @abstractmethod
    def to_dict(self) -> Dict[str, Any]:
        """Dictionary representation of the result."""

    def validate(self) -> bool:
        """Subclasses may override with content checks."""
        return True

    @property
    def df(self):
        """Tabular (pandas DataFrame) view of the result
        (reference results_base.py:52-59). Subclasses that have a
        natural table override this."""
        import pandas as pd
        return pd.DataFrame([self.to_dict()])

    def summary(self) -> str:
        """Human-readable text summary (reference results_base.py:247-254)."""
        return str(self)


class ArithmeticMixin:
    """Currency-checked arithmetic for amount-bearing results."""

    def _check_compatible(self, other):
        if getattr(self, "currency", None) is not getattr(other, "currency",
                                                          None):
            raise ValueError(
                f"Currency mismatch: {getattr(self, 'currency', None)} vs "
                f"{getattr(other, 'currency', None)}")


class ExportMixin:
    """to_json / to_csv / to_excel via the subclass's DataFrame view."""

    def to_json(self, indent: Optional[int] = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, default=str)

    def to_csv(self, filepath: Optional[str] = None) -> Optional[str]:
        df = self.df
        if filepath:
            df.to_csv(filepath)
            return None
        return df.to_csv()

    def to_excel(self, filepath: str, sheet_name: str = "Result"):
        self.df.to_excel(filepath, sheet_name=sheet_name)


class VisualizationMixin:
    """plot() hook — plotly is optional; raise a clear error if absent."""

    def plot(self, **kwargs):
        raise NotImplementedError(
            f"{type(self).__name__} does not define a plot")

    def summary(self) -> str:
        """Human-readable text summary (reference results_base.py:247-254
        puts this on the visualization mixin; BaseResult also carries it
        for classes that skip the mixin)."""
        return str(self)


class AggregationMixin:
    """Totals over amount collections."""

    @property
    def total_amount(self) -> float:
        return float(sum(getattr(cf, "amount", 0.0)
                         for cf in getattr(self, "_items", [])))

    @property
    def total_pv(self) -> float:
        return float(sum(getattr(cf, "discounted_amount", 0.0)
                         for cf in getattr(self, "_items", [])))

    def sum(self):
        """Sum all elements (reference results_base.py:264-273); containers
        with a natural total override — default is the PV total."""
        return self.total_pv

    def aggregate(self, func):
        """Apply a custom aggregation over the contained items
        (reference results_base.py:275-285)."""
        return func(list(getattr(self, "_items", [])))


class ValidationMixin:
    """NaN/Inf/shape/currency validators (results_base.py:288-356)."""

    @staticmethod
    def validate_no_nan(arr, name: str = "array") -> None:
        a = np.asarray(arr, dtype=float)
        if np.any(np.isnan(a)):
            raise ValueError(f"{name} contains NaN values")

    @staticmethod
    def validate_no_inf(arr, name: str = "array") -> None:
        a = np.asarray(arr, dtype=float)
        if np.any(np.isinf(a)):
            raise ValueError(f"{name} contains Inf values")

    @staticmethod
    def validate_finite(arr, name: str = "array") -> None:
        ValidationMixin.validate_no_nan(arr, name)
        ValidationMixin.validate_no_inf(arr, name)

    @staticmethod
    def validate_shape(arr, expected_shape, name: str = "array") -> None:
        a = np.asarray(arr)
        if a.shape != tuple(expected_shape):
            raise ValueError(
                f"{name} has shape {a.shape}, expected {expected_shape}")

    @staticmethod
    def validate_square(arr, name: str = "matrix") -> None:
        a = np.asarray(arr)
        if a.ndim != 2 or a.shape[0] != a.shape[1]:
            raise ValueError(f"{name} must be square, got {a.shape}")

    @staticmethod
    def validate_shape_match(arr, tenors, name: str = "array") -> bool:
        """Array length must match the tenor label count
        (reference results_base.py:334-353)."""
        a = np.asarray(arr)
        if a.shape[0] != len(tenors):
            raise ValueError(
                f"{name} length {a.shape[0]} does not match "
                f"{len(tenors)} tenors")
        return True

    @staticmethod
    def validate_currency_match(currency1, currency2,
                                operation: str = "operation") -> bool:
        """Two currencies must match for the given operation
        (reference results_base.py:356-376)."""
        if currency1 is not currency2:
            raise ValueError(
                f"Currency mismatch in {operation}: "
                f"{getattr(currency1, 'name', currency1)} vs "
                f"{getattr(currency2, 'name', currency2)}")
        return True
