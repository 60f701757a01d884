from .market_data_engine import FXRoutingEngine
