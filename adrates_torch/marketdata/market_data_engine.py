"""FX cross routing over the currency-pair graph.

Port of ``adrates_tpu/marketdata/market_data_engine.py:FXRoutingEngine``
(:128-221), word for word: Dijkstra by hop count with the same heap
tuples, so ties break the same way; per-currency routing overrides;
``rate``, ``get_cross_rate``, ``get_path`` and
``get_cross_rate_with_path``. Stdlib only.

Not ported: ``MarketCurveBuilder`` and ``market_data_constants.py``, the
Bloomberg paths, which need ``xbbg`` and a terminal.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Tuple

from ..utils.error import LibError


class FXRoutingEngine:
    """FX cross rates via Dijkstra over the currency-pair graph, with
    per-currency routing overrides."""

    def __init__(self, fx_params: Optional[dict] = None):
        self._fx_rates: Dict[str, float] = {}
        self._graph: Dict[str, Dict[str, float]] = {}
        self._overrides: Dict[str, str] = {}
        if fx_params:
            for pair, rec in fx_params.items():
                price = rec["price"] if isinstance(rec, dict) else rec
                self.set_fx_rate(pair, price)

    def set_fx_rate(self, pair: str, rate: float):
        pair = pair.upper()
        if rate <= 0:
            raise LibError(f"FX rate must be positive: {pair}={rate}")
        ccy1, ccy2 = pair[:3], pair[3:]
        self._fx_rates[pair] = rate
        self._graph.setdefault(ccy1, {})[ccy2] = rate
        self._graph.setdefault(ccy2, {})[ccy1] = 1.0 / rate

    def set_bulk_fx_rates(self, fx_dict: Dict[str, float]):
        for pair, rate in fx_dict.items():
            self.set_fx_rate(pair, rate)

    def set_override(self, ccy: str, via: str):
        self._overrides[ccy.upper()] = via.upper()

    # ------------------------------------------------------------------

    def _dijkstra(self, src: str, tgt: str
                  ) -> Tuple[Optional[float], List[str]]:
        """Min-hop/min-log-cost path src -> tgt; returns (rate, path)."""
        src, tgt = src.upper(), tgt.upper()
        if src not in self._graph or tgt not in self._graph:
            return None, []
        visited = set()
        heap = [(0.0, src, [src], 1.0)]
        while heap:
            cost, current, path, rate = heapq.heappop(heap)
            if current == tgt:
                return rate, path
            if current in visited:
                continue
            visited.add(current)
            for nxt, edge in self._graph[current].items():
                if nxt not in visited:
                    heapq.heappush(heap, (cost + 1.0, nxt, path + [nxt],
                                          rate * edge))
        return None, []

    def get_cross_rate(self, base: str, quote: str) -> float:
        """Rate converting 1 unit of ``base`` into ``quote``."""
        base, quote = base.upper(), quote.upper()
        if base == quote:
            return 1.0
        # overrides force an intermediate hop
        if base in self._overrides:
            via = self._overrides[base]
            return self.get_cross_rate(base if via == base else via,
                                       quote) * self._leg_rate(base, via)
        rate, path = self._dijkstra(base, quote)
        if rate is None:
            raise LibError(f"No FX route from {base} to {quote}")
        return rate

    def _leg_rate(self, src: str, via: str) -> float:
        rate, _ = self._dijkstra(src, via)
        if rate is None:
            raise LibError(f"No FX route from {src} to {via}")
        return rate

    def rate(self, pair: str) -> float:
        """Rate for a 6-char pair string via direct quote or routing."""
        pair = pair.upper()
        if pair in self._fx_rates:
            return self._fx_rates[pair]
        return self.get_cross_rate(pair[:3], pair[3:])

    def get_path(self, base: str, quote: str) -> List[str]:
        _, path = self._dijkstra(base, quote)
        return path

    def get_cross_rate_with_path(self, base: str, quote: str):
        """(rate, conversion path) — (None, []) when no route exists
        (parity: reference market_data_engine.py:424-455)."""
        base, quote = base.upper(), quote.upper()
        if base == quote:
            return 1.0, [base]
        rate, path = self._dijkstra(base, quote)
        if rate is None:
            return None, []
        return rate, path
