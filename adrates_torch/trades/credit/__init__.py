from .bond import Bond
from .frn import FRN
