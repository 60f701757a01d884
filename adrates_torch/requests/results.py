"""Typed analytics result containers.

Copy of ``adrates_tpu/requests/results.py`` (plain numpy): Valuation,
Value, Ladder, Delta, Gamma, Speed, CrossGamma, Risk, CashflowItem,
Cashflows and AnalyticsResult, with their currency- and curve-checked
``__add__``. Arrays are numpy on the host side: the engine copies a
request's outputs off the device once and builds these from that copy.
pandas is imported inside the ``df`` views (and so ``to_csv`` /
``to_excel``) only, so the module imports where pandas is not installed.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np

from ..utils.currency import CurrencyTypes
from ..utils.date import Date
from ..utils.global_types import CurveTypes
from .results_base import (AggregationMixin, BaseResult, ExportMixin,
                           ValidationMixin)


@dataclass(frozen=True)
class Valuation:
    """A monetary amount with currency; currency-checked arithmetic."""
    amount: float
    currency: CurrencyTypes = CurrencyTypes.NONE

    def __post_init__(self):
        if not isinstance(self.currency, CurrencyTypes):
            raise TypeError(
                f"currency must be a CurrencyTypes enum, "
                f"got {type(self.currency)}")

    def __repr__(self) -> str:
        return f"{self.amount:.2f} {self.currency.name}"

    def __add__(self, other: Any) -> "Valuation":
        if not isinstance(other, Valuation):
            return NotImplemented
        if self.currency is not other.currency:
            raise ValueError(
                f"Cannot add {self.currency.name} to {other.currency.name}")
        return Valuation(self.amount + other.amount, self.currency)

    def __radd__(self, other: Any) -> "Valuation":
        if other == 0:
            return self
        return self.__add__(other)

    def __sub__(self, other: Any) -> "Valuation":
        if not isinstance(other, Valuation):
            return NotImplemented
        if self.currency is not other.currency:
            raise ValueError(
                f"Cannot subtract {other.currency.name} from "
                f"{self.currency.name}")
        return Valuation(self.amount - other.amount, self.currency)

    def __mul__(self, factor: float) -> "Valuation":
        return Valuation(self.amount * factor, self.currency)

    __rmul__ = __mul__

    def __truediv__(self, divisor: float) -> "Valuation":
        return Valuation(self.amount / divisor, self.currency)

    def to_dict(self) -> Dict[str, Any]:
        return {"amount": float(self.amount), "currency": self.currency.name}

    def to_json(self, indent: Optional[int] = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @property
    def df(self) -> "pandas.DataFrame":
        import pandas as pd
        return pd.DataFrame([self.to_dict()])

    def to_csv(self, filepath: Optional[str] = None) -> Optional[str]:
        if filepath:
            self.df.to_csv(filepath)
            return None
        return self.df.to_csv()

    def to_excel(self, filepath: str, sheet_name: str = "Valuation"):
        self.df.to_excel(filepath, sheet_name=sheet_name)


@dataclass(frozen=True)
class Value:
    """Lightweight amount+currency used for aggregated displays."""
    amount: float
    currency: CurrencyTypes = CurrencyTypes.NONE

    def __repr__(self) -> str:
        return f"{self.amount:.2f} {self.currency.name}"


class Ladder:
    """Tenor -> sensitivity mapping with a DataFrame view."""

    def __init__(self, data: Dict[str, float], curve_name: str):
        self.data = data
        self._curve_name = curve_name

    @property
    def df(self) -> "pandas.DataFrame":
        import pandas as pd
        df = pd.DataFrame.from_dict(self.data, orient="index",
                                    columns=[f"{self._curve_name}_Risk"])
        df.index.name = "Tenor"
        return df

    def to_dict(self) -> Dict[str, float]:
        return dict(self.data)

    def __repr__(self):
        return (f"Ladder(curve={self._curve_name}, points={len(self.data)}, "
                f"curve_data={self.data})")


def _as_np(arr) -> np.ndarray:
    return np.asarray(arr, dtype=np.float64)


@dataclass(frozen=True)
class Delta:
    """Tenor-bucketed first-order sensitivity ladder (ccy per bp)."""
    risk_ladder: np.ndarray
    tenors: List[str]
    currency: CurrencyTypes
    curve_type: CurveTypes

    def __post_init__(self):
        object.__setattr__(self, "risk_ladder", _as_np(self.risk_ladder))
        if len(self.risk_ladder) != len(self.tenors):
            raise ValueError(
                f"Expected {len(self.risk_ladder)} tenors, "
                f"got {len(self.tenors)}")
        if not isinstance(self.currency, CurrencyTypes):
            raise TypeError(
                f"currency must be CurrencyTypes, got {type(self.currency)}")
        if not isinstance(self.curve_type, CurveTypes):
            raise TypeError(
                f"curve_type must be CurveTypes, got {type(self.curve_type)}")

    @property
    def value(self) -> Value:
        return Value(float(np.sum(self.risk_ladder)), self.currency)

    @property
    def ladder(self) -> Ladder:
        return Ladder(dict(zip(self.tenors, self.risk_ladder.tolist())),
                      self.curve_type.name)

    def __call__(self, curve_type: CurveTypes) -> "Delta":
        """Risk-style lookup on a single-curve ladder, so `res.risk(ct)`
        works whether the engine packaged one Delta or a Risk container
        (reference results.py Risk.__call__)."""
        if curve_type != self.curve_type:
            raise KeyError(
                f"No delta for {curve_type.name}; this ladder is on "
                f"{self.curve_type.name}")
        return self

    @property
    def df(self) -> "pandas.DataFrame":
        return self.ladder.df

    def __repr__(self):
        return (f"Delta({self.curve_type.name}: "
                f"{self.value.amount:.6g} {self.currency.name}, "
                f"points={len(self.tenors)})")

    def __add__(self, other: Any) -> "Delta":
        if not isinstance(other, Delta):
            return NotImplemented
        if (self.curve_type != other.curve_type
                or self.currency != other.currency
                or self.tenors != other.tenors):
            raise ValueError("Cannot add Delta with mismatched curve_type, "
                             "currency, or tenors")
        return Delta(self.risk_ladder + other.risk_ladder, self.tenors,
                     self.currency, self.curve_type)

    __radd__ = __add__

    def to_dict(self) -> Dict[str, Any]:
        return {"risk_ladder": self.risk_ladder.tolist(),
                "tenors": self.tenors,
                "currency": self.currency.name,
                "curve_type": self.curve_type.name,
                "total": float(np.sum(self.risk_ladder))}

    def to_json(self, indent: Optional[int] = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    def to_csv(self, filepath: Optional[str] = None) -> Optional[str]:
        if filepath:
            self.df.to_csv(filepath)
            return None
        return self.df.to_csv()

    def to_excel(self, filepath: str, sheet_name: str = "Delta"):
        self.df.to_excel(filepath, sheet_name=sheet_name)


@dataclass(frozen=True)
class Gamma:
    """NxN second-order sensitivity matrix (ccy per bp^2)."""
    risk_ladder: np.ndarray
    tenors: List[str]
    currency: CurrencyTypes
    curve_type: CurveTypes

    def __post_init__(self):
        object.__setattr__(self, "risk_ladder", _as_np(self.risk_ladder))
        if self.risk_ladder.shape[0] != len(self.tenors):
            raise ValueError(
                f"Expected {self.risk_ladder.shape[0]} tenors, "
                f"got {len(self.tenors)}")
        if not isinstance(self.currency, CurrencyTypes):
            raise TypeError(
                f"currency must be CurrencyTypes, got {type(self.currency)}")
        if not isinstance(self.curve_type, CurveTypes):
            raise TypeError(
                f"curve_type must be CurveTypes, got {type(self.curve_type)}")

    @property
    def value(self) -> Value:
        return Value(float(np.sum(self.risk_ladder)), self.currency)

    @property
    def risk_matrix(self) -> np.ndarray:
        """Dense [N, N] matrix view (1-D diagonal ladders expand)."""
        m = self.risk_ladder
        return np.diag(m) if m.ndim == 1 else m

    def __call__(self, curve_type: CurveTypes) -> "Gamma":
        """Risk-style lookup on a single-curve matrix (see Delta)."""
        if curve_type != self.curve_type:
            raise KeyError(
                f"No gamma for {curve_type.name}; this matrix is on "
                f"{self.curve_type.name}")
        return self

    @property
    def matrix(self) -> Dict[str, Dict[str, float]]:
        """Nested dict view {tenor_row: {tenor_col: gamma}}."""
        m = self.risk_ladder
        if m.ndim == 1:
            return {t: {t2: (float(m[i]) if i == j else 0.0)
                        for j, t2 in enumerate(self.tenors)}
                    for i, t in enumerate(self.tenors)}
        return {t: {t2: float(m[i, j])
                    for j, t2 in enumerate(self.tenors)}
                for i, t in enumerate(self.tenors)}

    @property
    def df(self) -> "pandas.DataFrame":
        m = self.risk_ladder
        if m.ndim == 1:
            m = np.diag(m)
        import pandas as pd
        df = pd.DataFrame(m, index=self.tenors, columns=self.tenors)
        df.index.name = "Tenor"
        return df

    def to_dict(self) -> Dict[str, Any]:
        return {"matrix": self.matrix,
                "tenors": self.tenors,
                "currency": self.currency.name,
                "curve_type": self.curve_type.name,
                "total": float(np.sum(self.risk_ladder))}

    def to_json(self, indent: Optional[int] = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    def to_csv(self, filepath: Optional[str] = None) -> Optional[str]:
        if filepath:
            self.df.to_csv(filepath)
            return None
        return self.df.to_csv()

    def to_excel(self, filepath: str, sheet_name: str = "Gamma"):
        self.df.to_excel(filepath, sheet_name=sheet_name)

    def plot(self, **kwargs):
        """Interactive gamma heatmap (requires plotly)."""
        try:
            import plotly.graph_objects as go
        except ImportError as exc:
            raise ImportError("plotly is required for Gamma.plot()") from exc
        m = self.risk_ladder
        if m.ndim == 1:
            m = np.diag(m)
        fig = go.Figure(data=go.Heatmap(
            z=m, x=self.tenors, y=self.tenors, colorscale="RdBu",
            zmid=0.0, **kwargs))
        fig.update_layout(
            title=f"Gamma — {self.curve_type.name} ({self.currency.name})",
            xaxis_title="Tenor", yaxis_title="Tenor")
        fig.show()
        return fig

    def __repr__(self):
        return (f"Gamma({self.curve_type.name}: "
                f"{self.value.amount:.6g} {self.currency.name}, "
                f"points={len(self.tenors)})")

    def __add__(self, other: Any) -> "Gamma":
        if not isinstance(other, Gamma):
            return NotImplemented
        if (self.curve_type != other.curve_type
                or self.currency != other.currency
                or self.tenors != other.tenors):
            raise ValueError("Cannot add Gamma with mismatched curve_type, "
                             "currency, or tenors")
        return Gamma(self.risk_ladder + other.risk_ladder, self.tenors,
                     self.currency, self.curve_type)

    __radd__ = __add__


@dataclass(frozen=True)
class Speed:
    """NxNxN third-order sensitivity cube (ccy per bp³).

    The reference DEFINES RequestTypes.SPEED (global_types.py:~34) but
    never implements it; this container + the engine's third-order AD
    tower close the gap. risk_cube[i, j, k] = ∂³PV/∂q_i∂q_j∂q_k,
    scaled 1e-12 (per-bp³) by the engine."""
    risk_cube: np.ndarray
    tenors: List[str]
    currency: CurrencyTypes
    curve_type: CurveTypes

    def __post_init__(self):
        object.__setattr__(self, "risk_cube", _as_np(self.risk_cube))
        n = len(self.tenors)
        if self.risk_cube.shape != (n, n, n):
            raise ValueError(
                f"Expected cube shape {(n, n, n)}, "
                f"got {self.risk_cube.shape}")
        if not isinstance(self.currency, CurrencyTypes):
            raise TypeError(
                f"currency must be CurrencyTypes, got {type(self.currency)}")
        if not isinstance(self.curve_type, CurveTypes):
            raise TypeError(
                f"curve_type must be CurveTypes, got {type(self.curve_type)}")

    @property
    def value(self) -> Value:
        return Value(float(np.sum(self.risk_cube)), self.currency)

    def slice(self, tenor: str) -> Gamma:
        """The NxN gamma-sensitivity-to-one-pillar slice ∂Γ/∂q_tenor."""
        i = self.tenors.index(tenor)
        return Gamma(self.risk_cube[i], self.tenors, self.currency,
                     self.curve_type)

    def to_dict(self) -> Dict[str, Any]:
        return {"cube": self.risk_cube.tolist(),
                "tenors": self.tenors,
                "currency": self.currency.name,
                "curve_type": self.curve_type.name,
                "total": float(np.sum(self.risk_cube))}

    def to_json(self, indent: Optional[int] = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    def __repr__(self):
        return (f"Speed({self.curve_type.name}: "
                f"{self.value.amount:.6g} {self.currency.name}, "
                f"points={len(self.tenors)})")

    def __add__(self, other: Any) -> "Speed":
        if not isinstance(other, Speed):
            return NotImplemented
        if (self.curve_type != other.curve_type
                or self.currency != other.currency
                or self.tenors != other.tenors):
            raise ValueError("Cannot add Speed with mismatched curve_type, "
                             "currency, or tenors")
        return Speed(self.risk_cube + other.risk_cube, self.tenors,
                     self.currency, self.curve_type)

    __radd__ = __add__


@dataclass(frozen=True)
class CrossGamma:
    """Rectangular second-order sensitivity across two curves."""
    risk_matrix: np.ndarray            # [N1, N2]
    tenors_curve1: List[str]
    tenors_curve2: List[str]
    currency: CurrencyTypes
    curve_type_1: CurveTypes
    curve_type_2: CurveTypes

    def __post_init__(self):
        object.__setattr__(self, "risk_matrix", _as_np(self.risk_matrix))
        if self.risk_matrix.shape != (len(self.tenors_curve1),
                                      len(self.tenors_curve2)):
            raise ValueError(
                f"Cross-gamma shape {self.risk_matrix.shape} does not match "
                f"tenors ({len(self.tenors_curve1)}, "
                f"{len(self.tenors_curve2)})")

    @property
    def value(self) -> Value:
        return Value(float(np.sum(self.risk_matrix)), self.currency)

    @property
    def matrix(self) -> Dict[str, Dict[str, float]]:
        return {t1: {t2: float(self.risk_matrix[i, j])
                     for j, t2 in enumerate(self.tenors_curve2)}
                for i, t1 in enumerate(self.tenors_curve1)}

    @property
    def df(self) -> "pandas.DataFrame":
        import pandas as pd
        df = pd.DataFrame(self.risk_matrix, index=self.tenors_curve1,
                          columns=self.tenors_curve2)
        df.index.name = f"{self.curve_type_1.name} \\ {self.curve_type_2.name}"
        return df

    def to_dict(self) -> Dict[str, Any]:
        return {"matrix": self.matrix,
                "tenors_curve1": self.tenors_curve1,
                "tenors_curve2": self.tenors_curve2,
                "currency": self.currency.name,
                "curve_type_1": self.curve_type_1.name,
                "curve_type_2": self.curve_type_2.name,
                "total": float(np.sum(self.risk_matrix))}

    def to_json(self, indent: Optional[int] = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    def to_csv(self, filepath: Optional[str] = None) -> Optional[str]:
        """Matrix as CSV (reference results.py CrossGamma.to_csv)."""
        if filepath:
            self.df.to_csv(filepath)
            return None
        return self.df.to_csv()

    def to_excel(self, filepath: str, sheet_name: str = "CrossGamma"):
        self.df.to_excel(filepath, sheet_name=sheet_name)

    def plot(self, **kwargs):
        try:
            import plotly.graph_objects as go
        except ImportError as exc:
            raise ImportError(
                "plotly is required for CrossGamma.plot()") from exc
        fig = go.Figure(data=go.Heatmap(
            z=self.risk_matrix, x=self.tenors_curve2, y=self.tenors_curve1,
            colorscale="RdBu", zmid=0.0, **kwargs))
        fig.update_layout(
            title=f"Cross-gamma {self.curve_type_1.name} x "
                  f"{self.curve_type_2.name}",
            xaxis_title=self.curve_type_2.name,
            yaxis_title=self.curve_type_1.name)
        fig.show()
        return fig

    def __repr__(self):
        return (f"CrossGamma({self.curve_type_1.name} x "
                f"{self.curve_type_2.name}: {self.value.amount:.6g} "
                f"{self.currency.name})")


class Risk:
    """Per-curve Delta/Gamma registry with attribute, callable and
    cross-gamma access."""

    def __init__(self,
                 ladders: Iterable[Union[Delta, Gamma]],
                 cross_gammas: Optional[Iterable[CrossGamma]] = None):
        self._by_curve: Dict[str, Union[Delta, Gamma]] = {}
        self._cross_gammas: Dict[Tuple[str, str], CrossGamma] = {}
        for ladder in ladders:
            name = ladder.curve_type.name
            if name in self._by_curve:
                raise ValueError(f"Duplicate curve {name}")
            self._by_curve[name] = ladder
            setattr(self, name, ladder)
        if cross_gammas is not None:
            for cg in cross_gammas:
                key = (cg.curve_type_1.name, cg.curve_type_2.name)
                if key in self._cross_gammas:
                    raise ValueError(f"Duplicate cross-gamma for {key}")
                self._cross_gammas[key] = cg

    def __call__(self, curve_type: CurveTypes) -> Union[Delta, Gamma]:
        try:
            return self._by_curve[curve_type.name]
        except KeyError:
            raise ValueError(f"No risk data for curve: {curve_type.name}")

    def cross_gamma(self, curve_type_1: CurveTypes,
                    curve_type_2: CurveTypes) -> Optional[CrossGamma]:
        return self._cross_gammas.get(
            (curve_type_1.name, curve_type_2.name))

    def has_cross_gamma(self, curve_type_1: CurveTypes,
                        curve_type_2: CurveTypes) -> bool:
        return (curve_type_1.name,
                curve_type_2.name) in self._cross_gammas

    @property
    def all_cross_gammas(self) -> Dict[Tuple[str, str], CrossGamma]:
        return self._cross_gammas.copy()

    def __repr__(self):
        parts = [f"{name}={obj.value.amount:.6g} {obj.value.currency.name}"
                 for name, obj in self._by_curve.items()]
        return f"Risk({', '.join(parts)})"


@dataclass(frozen=True)
class CashflowItem:
    """One payment: dates, amounts, discounting and leg tag."""
    payment_date: Date
    notional: float
    payment_fraction: float
    accrual_period: float
    amount: float
    discount_factor: float
    discounted_amount: float
    leg_type: str

    def to_dict(self) -> Dict[str, Any]:
        return {"payment_date": str(self.payment_date),
                "notional": float(self.notional),
                "payment_fraction": float(self.payment_fraction),
                "accrual_period": float(self.accrual_period),
                "amount": float(self.amount),
                "discount_factor": float(self.discount_factor),
                "discounted_amount": float(self.discounted_amount),
                "leg_type": self.leg_type}


class Cashflows(BaseResult, ExportMixin, AggregationMixin):
    """Collection of CashflowItems with filters and totals."""

    def __init__(self, cashflows: List[CashflowItem],
                 currency: CurrencyTypes):
        self._items = list(cashflows)
        self.currency = currency

    def validate(self) -> bool:
        ValidationMixin.validate_finite(
            [cf.amount for cf in self._items], "cashflow amounts")
        return True

    def to_dict(self) -> Dict[str, Any]:
        return {"currency": self.currency.name,
                "cashflows": [cf.to_dict() for cf in self._items]}

    @property
    def df(self) -> "pandas.DataFrame":
        import pandas as pd
        return pd.DataFrame([cf.to_dict() for cf in self._items])

    def _filter(self, pred) -> "Cashflows":
        return Cashflows([cf for cf in self._items if pred(cf)],
                         self.currency)

    @property
    def fixed(self) -> "Cashflows":
        return self._filter(lambda cf: cf.leg_type.startswith("Fixed"))

    @property
    def floating(self) -> "Cashflows":
        return self._filter(lambda cf: cf.leg_type.startswith("Float"))

    @property
    def pay(self) -> "Cashflows":
        return self._filter(lambda cf: cf.leg_type.endswith("Pay"))

    @property
    def receive(self) -> "Cashflows":
        return self._filter(lambda cf: cf.leg_type.endswith("Rec"))

    @property
    def notional_exchange(self) -> "Cashflows":
        return self._filter(lambda cf: cf.leg_type.startswith("Notional"))

    def sum(self) -> Valuation:
        return Valuation(self.total_pv, self.currency)

    def __iter__(self):
        return iter(self._items)

    def __len__(self) -> int:
        return len(self._items)

    def __repr__(self) -> str:
        return (f"Cashflows({len(self._items)} items, "
                f"total_pv={self.total_pv:.2f} {self.currency.name})")


class AnalyticsResult:
    """Bundle of {value, risk (delta), gamma, cashflows} for one compute."""

    def __init__(self,
                 value: Optional[Valuation] = None,
                 risk: Optional[Union[Risk, Delta]] = None,
                 gamma: Optional[Union[Risk, Gamma]] = None,
                 cashflows: Optional[Cashflows] = None,
                 speed: Optional[Speed] = None):
        self._value = value
        self._risk = risk
        self._gamma = gamma
        self._cashflows = cashflows
        self._speed = speed

    @property
    def speed(self) -> Optional["Speed"]:
        return self._speed

    @property
    def value(self) -> Optional[Valuation]:
        return self._value

    @property
    def risk(self):
        return self._risk

    @property
    def gamma(self):
        return self._gamma

    @property
    def cashflows(self) -> Optional[Cashflows]:
        return self._cashflows

    def __repr__(self):
        parts = []
        if self._value is not None:
            parts.append(f"value={self._value!r}")
        if self._risk is not None:
            parts.append(f"risk={self._risk!r}")
        if self._gamma is not None:
            parts.append(f"gamma={self._gamma!r}")
        if self._cashflows is not None:
            parts.append(f"cashflows={self._cashflows!r}")
        if self._speed is not None:
            parts.append(f"speed={self._speed!r}")
        return f"AnalyticsResult({', '.join(parts)})"
