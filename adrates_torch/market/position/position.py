"""Position: a (derivative, model) pair that runs the engine.

Port of ``adrates_tpu/market/position/position.py``, with the device the
engine runs on (the CUDA card unless the caller asks for another).
"""

from __future__ import annotations

from ...requests.results import AnalyticsResult
from .engine import Engine


class Position:
    """A derivative viewed against a model; computes requested analytics
    on ``device`` (None: the CUDA card, raising where none is visible)."""

    def __init__(self, derivative, model, device=None):
        self.derivative = derivative
        self.model = model
        self._engine = Engine(model, device)

    @property
    def device(self):
        return self._engine.device

    def compute(self, request_list, collateral_type=None) -> AnalyticsResult:
        """Run the engine for the requested analytics
        (VALUE/DELTA/GAMMA/SPEED/CASHFLOWS)."""
        return self._engine.compute(self.derivative, set(request_list),
                                    collateral_type)

    def __repr__(self):
        return (f"Position({self.derivative!r}, "
                f"model@{self.model.value_dt}, device={self.device})")
