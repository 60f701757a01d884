from .inflation_index import InflationIndex
