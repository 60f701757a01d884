from .ois import OIS, FinCompoundingTypes
from .ois_curve import OISCurve, SWAP_TOL
from .swap_fixed_leg import SwapFixedLeg
from .swap_float_leg import SwapFloatLeg
from .xccy_basis_swap import XccyBasisSwap
from .xccy_curve import XccyCurve
from .xccy_fix_float_swap import XccyFixFloat
from .xccy_fix_fix_swap import XccyFixFix
from .swap_inflation_leg import SwapInflationLeg
from .swap_yoy_inflation_leg import SwapYoYInflationLeg
from .zcis import ZeroCouponInflationSwap
from .yoy_inflation_swap import YoYInflationSwap
