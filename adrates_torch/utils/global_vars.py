"""Global numeric constants.

Parity: the reference's cavour/utils/global_vars.py:1-5.
"""

gDaysInYear = 365.0
gSmall = 1e-12
g_small = gSmall
