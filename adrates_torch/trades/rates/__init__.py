from .ois import OIS, FinCompoundingTypes
from .ois_curve import OISCurve, SWAP_TOL
from .swap_fixed_leg import SwapFixedLeg
from .swap_float_leg import SwapFloatLeg
