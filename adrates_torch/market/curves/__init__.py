from .discount_curve import DiscountCurve
from .interpolator import Interpolator, InterpolatorAd, interpolate
