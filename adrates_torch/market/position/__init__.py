from .engine import Engine
from .position import Position
