"""RequestTypes re-export (the enum lives in ``utils.global_types``)."""
from ..utils.global_types import RequestTypes  # noqa: F401
