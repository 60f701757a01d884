from .portfolio import Portfolio
