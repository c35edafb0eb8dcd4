"""Uniform applied-field source.

Parity with the reference ``superscreen/sources/constant.py:8-32``: a
:class:`Parameter` whose value is independent of position.
"""

import numpy as np

from ..parameter import Parameter

__all__ = ["ConstantField"]


def constant(x, y, z, value=0):
    """The same ``value`` at every evaluation point (broadcast to x's shape)."""
    return np.full(np.shape(np.asarray(x, dtype=float)), float(value))


def ConstantField(value: float = 0) -> Parameter:
    """A Parameter returning ``value`` at all ``(x, y, z)``.

    Args:
        value: The constant value of the field.
    """
    return Parameter(constant, value=float(value))
