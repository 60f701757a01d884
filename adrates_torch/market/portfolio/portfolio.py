"""Portfolio: a list of positions with summed analytics.

Port of ``adrates_tpu/market/portfolio/portfolio.py``: ``compute`` runs
each position on its own engine (and so its own device) and sums the
result objects through their currency- and curve-checked ``__add__``.
For book-scale batched pricing use ``adrates_torch.parallel`` instead.
"""

from __future__ import annotations

from typing import List

from ...requests.results import AnalyticsResult
from ..position.position import Position


class Portfolio:
    """A collection of positions."""

    def __init__(self, positions: List[Position] = None):
        self.positions = list(positions or [])

    def add(self, position: Position):
        self.positions.append(position)

    # reference API name (portfolio.py add_position)
    add_position = add

    def compute(self, request_list, collateral_type=None) -> AnalyticsResult:
        """Sum per-position analytics (value/delta/gamma add via the
        result classes' currency- and curve-checked __add__)."""
        value = None
        risk = None
        gamma = None
        for pos in self.positions:
            res = pos.compute(request_list, collateral_type)
            value = res.value if value is None else value + res.value
            risk = res.risk if risk is None else risk + res.risk
            gamma = res.gamma if gamma is None else gamma + res.gamma
        return AnalyticsResult(value=value, risk=risk, gamma=gamma)

    def __len__(self):
        return len(self.positions)

    def __repr__(self):
        return f"Portfolio({len(self.positions)} positions)"
