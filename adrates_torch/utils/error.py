"""Library-wide exception type.

Parity: the reference's cavour/utils/error.py:21-31 (LibError carrying a message).
"""


class LibError(Exception):
    """Exception raised for all library-level errors (bad conventions,
    calibration failures, invalid inputs)."""

    def __init__(self, message: str):
        self._message = message
        super().__init__(message)

    @property
    def message(self) -> str:
        return self._message
