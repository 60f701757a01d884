from .discount_curve import DiscountCurve
