"""Currency enumeration.

Parity: the reference's cavour/utils/currency.py:52-67 (15 currencies).
"""

from enum import Enum


class CurrencyTypes(Enum):
    USD = 1
    EUR = 2
    GBP = 3
    CHF = 4
    CAD = 5
    AUD = 6
    NZD = 7
    DKK = 8
    SEK = 9
    HKD = 10
    NOK = 11
    JPY = 12
    PLN = 13
    ZAR = 14
    NONE = 15
    RON = 16
