from .results import (AnalyticsResult, CashflowItem, Cashflows, CrossGamma,
                      Delta, Gamma, Ladder, Risk, Speed, Valuation, Value)
from .results_base import (AggregationMixin, ArithmeticMixin, BaseResult,
                           ExportMixin, ValidationMixin, VisualizationMixin)
