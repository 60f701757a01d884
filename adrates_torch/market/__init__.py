from .curves.discount_curve import DiscountCurve
from .position.position import Position
from .position.engine import Engine
from .portfolio.portfolio import Portfolio
