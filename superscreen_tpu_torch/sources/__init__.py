"""Applied-field sources."""

from .constant import ConstantField

__all__ = ["ConstantField"]
