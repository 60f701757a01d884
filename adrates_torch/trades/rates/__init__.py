from .ois import OIS, FinCompoundingTypes
from .ois_curve import OISCurve, SWAP_TOL
from .swap_fixed_leg import SwapFixedLeg
from .swap_float_leg import SwapFloatLeg
from .xccy_basis_swap import XccyBasisSwap
from .xccy_curve import XccyCurve
