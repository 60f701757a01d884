from .cashflow import SingleFixedCashflow
