"""Global enumerations and collateral-routing helpers.

Parity: the reference's cavour/utils/global_types.py:53-294 (enums,
collateral_to_currency, get_discount_curve_name).
"""

from enum import Enum

from .currency import CurrencyTypes


class SwapTypes(Enum):
    PAY = 1
    RECEIVE = 2


class InstrumentTypes(Enum):
    SWAP_FIXED_LEG = 1
    SWAP_FLOAT_LEG = 2
    OIS_SWAP = 3
    XCCY_SWAP = 4
    ZCIS = 5
    SWAP_INFLATION_LEG = 6
    BOND = 7
    FRN = 8
    YOY_INFLATION_SWAP = 9
    SWAP_YOY_INFLATION_LEG = 10


class RequestTypes(Enum):
    VALUE = 1
    DELTA = 2
    GAMMA = 3
    SPEED = 4
    CASHFLOWS = 5


class InterpTypes(Enum):
    FLAT_FWD_RATES = 1
    LINEAR_FWD_RATES = 2
    LINEAR_ZERO_RATES = 4
    FINCUBIC_ZERO_RATES = 7
    NATCUBIC_LOG_DISCOUNT = 8
    NATCUBIC_ZERO_RATES = 9
    PCHIP_ZERO_RATES = 10
    PCHIP_LOG_DISCOUNT = 11


class CurveTypes(Enum):
    GBP_OIS_SONIA = 1
    USD_OIS_SOFR = 2
    EUR_OIS_ESTR = 3
    USD_GBP_BASIS = 4
    GBP_RPI_INFLATION = 5
    GBP_CPI_INFLATION = 6
    USD_CPI_INFLATION = 7
    EUR_HICP_INFLATION = 8
    # Basis pairs beyond the reference's single USD_GBP entry
    # (multi-currency books report ladders per calibrated pair).
    GBP_USD_BASIS = 9
    EUR_USD_BASIS = 10
    USD_EUR_BASIS = 11
    EUR_GBP_BASIS = 12
    GBP_EUR_BASIS = 13
    # Further OIS benchmarks for multi-currency books.
    JPY_OIS_TONAR = 14
    CHF_OIS_SARON = 15
    AUD_OIS_AONIA = 16
    CAD_OIS_CORRA = 17
    JPY_USD_BASIS = 18
    CHF_USD_BASIS = 19
    AUD_USD_BASIS = 20
    CAD_USD_BASIS = 21


class InflationIndexTypes(Enum):
    UK_RPI = 1
    UK_CPI = 2
    UK_CPIH = 3
    US_CPI_U = 4
    EUR_HICP = 5
    EUR_HICP_EX = 6


class InflationInterpTypes(Enum):
    FLAT = 1
    LINEAR = 2
    COMPOUND = 3


class CollateralType(Enum):
    USD = 1
    GBP = 2
    EUR = 3
    JPY = 4
    CHF = 5
    AUD = 6
    CAD = 7
    USD_TIPS = 10
    EUR_OATS = 11
    EUR_BUNDS = 12
    GBP_GILTS = 13
    JGB = 14
    UNCOLLATERALIZED = 99


_COLLATERAL_CCY = {
    CollateralType.USD: CurrencyTypes.USD,
    CollateralType.GBP: CurrencyTypes.GBP,
    CollateralType.EUR: CurrencyTypes.EUR,
    CollateralType.JPY: CurrencyTypes.JPY,
    CollateralType.CHF: CurrencyTypes.CHF,
    CollateralType.AUD: CurrencyTypes.AUD,
    CollateralType.CAD: CurrencyTypes.CAD,
    CollateralType.USD_TIPS: CurrencyTypes.USD,
    CollateralType.EUR_OATS: CurrencyTypes.EUR,
    CollateralType.EUR_BUNDS: CurrencyTypes.EUR,
    CollateralType.GBP_GILTS: CurrencyTypes.GBP,
    CollateralType.JGB: CurrencyTypes.JPY,
}

_CURRENCY_COLLATERAL = {
    CollateralType.USD, CollateralType.GBP, CollateralType.EUR,
    CollateralType.JPY, CollateralType.CHF, CollateralType.AUD,
    CollateralType.CAD,
}

_BOND_COLLATERAL = {
    CollateralType.USD_TIPS, CollateralType.EUR_OATS,
    CollateralType.EUR_BUNDS, CollateralType.GBP_GILTS, CollateralType.JGB,
}

_OIS_CURVE_BY_CCY = {
    CurrencyTypes.USD: "USD_OIS_SOFR",
    CurrencyTypes.GBP: "GBP_OIS_SONIA",
    CurrencyTypes.EUR: "EUR_OIS_ESTR",
    CurrencyTypes.JPY: "JPY_OIS_TONAR",
    CurrencyTypes.CHF: "CHF_OIS_SARON",
    CurrencyTypes.AUD: "AUD_OIS_AONIA",
    CurrencyTypes.CAD: "CAD_OIS_CORRA",
}


def collateral_to_currency(collateral_type: CollateralType) -> CurrencyTypes:
    """Currency underlying a collateral type."""
    if collateral_type not in _COLLATERAL_CCY:
        raise ValueError(
            f"Cannot convert {collateral_type} to currency. "
            f"Use is_currency_collateral() to check first.")
    return _COLLATERAL_CCY[collateral_type]


def is_currency_collateral(collateral_type: CollateralType) -> bool:
    return collateral_type in _CURRENCY_COLLATERAL


def is_bond_collateral(collateral_type: CollateralType) -> bool:
    return collateral_type in _BOND_COLLATERAL


def get_discount_curve_name(cashflow_currency: CurrencyTypes,
                            collateral_type: CollateralType) -> str:
    """Discount curve name for (cashflow currency, collateral)."""
    if is_currency_collateral(collateral_type):
        collateral_ccy = collateral_to_currency(collateral_type)
        if cashflow_currency == collateral_ccy:
            if cashflow_currency not in _OIS_CURVE_BY_CCY:
                raise ValueError(
                    f"No OIS curve defined for {cashflow_currency}")
            return _OIS_CURVE_BY_CCY[cashflow_currency]
        return f"{cashflow_currency.name}_{collateral_ccy.name}_XCCY"
    if is_bond_collateral(collateral_type):
        return f"{cashflow_currency.name}_{collateral_type.name}_XCCY"
    if collateral_type == CollateralType.UNCOLLATERALIZED:
        raise ValueError(
            "Cannot generate curve name for UNCOLLATERALIZED. "
            "Uncollateralized discounting requires separate handling.")
    raise ValueError(f"Unsupported collateral type: {collateral_type}")
