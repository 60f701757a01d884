from .curves.discount_curve import DiscountCurve
