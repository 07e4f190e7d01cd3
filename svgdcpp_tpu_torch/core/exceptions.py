"""Exceptions and log prefix.

The same types, prefix and messages as ``svgdcpp_tpu.core.exceptions`` (the
reference's exception types, include/SVGDCpp/Exceptions.hpp:16-56), so code
and tests that match on the text work against either package.
"""

SVGD_LOG_PREFIX = "[SVGD-TPU] "


class SVGDError(Exception):
    """Base class for all svgdcpp_tpu_torch errors."""

    prefix = "[Error] "

    def __init__(self, message: str = ""):
        super().__init__(SVGD_LOG_PREFIX + self.prefix + message)


class DimensionMismatchError(SVGDError):
    """Raised when array/vector dimensions are incompatible.

    Mirrors DimensionMismatchException (Exceptions.hpp:23-36).
    """

    prefix = "[Dimension Mismatch Error] "


class UnsetError(SVGDError):
    """Raised when a required function/member has not been set.

    Mirrors UnsetException (Exceptions.hpp:43-56).
    """

    prefix = "[Unset Error] "


def compare_vector_sizes(a, b) -> bool:
    """Return True if two 1-D arrays have the same length.

    Mirrors CompareVectorSizes (Core.hpp:48-52).
    """
    return int(a.shape[0]) == int(b.shape[0])
