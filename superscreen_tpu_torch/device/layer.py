"""Layer: one plane of the device stack.

Counterpart of ``superscreen_tpu/device/layer.py`` for a constant
penetration depth.  A position-dependent ``Lambda`` (a callable
:class:`Parameter`) is not supported by this package yet.
"""

import numbers

__all__ = ["Layer"]


def _require_number(name: str, label: str, value) -> None:
    if value is not None and not isinstance(value, numbers.Real):
        raise NotImplementedError(
            f"Layer {name!r}: {label} must be a number; a position-dependent "
            f"{label} ({type(value).__name__}) is not supported."
        )


class Layer:
    """A single layer of a superconducting device.

    Args:
        name: Name of the layer.
        Lambda: Effective magnetic penetration depth of films in this layer.
            Mutually exclusive with ``london_lambda``/``thickness``.
        london_lambda: London penetration depth of films in this layer.
            Requires ``thickness``.
        thickness: Film thickness; requires ``london_lambda``.
        z0: Vertical position of the layer plane.
    """

    def __init__(self, name, Lambda=None, london_lambda=None, thickness=None, z0=0):
        for label, value in (
            ("Lambda", Lambda),
            ("london_lambda", london_lambda),
            ("thickness", thickness),
        ):
            _require_number(name, label, value)
        gave_london = london_lambda is not None or thickness is not None
        if Lambda is not None and gave_london:
            raise ValueError(
                f"Layer {name!r}: Lambda is mutually exclusive with "
                "london_lambda/thickness."
            )
        if Lambda is None and (london_lambda is None or thickness is None):
            raise ValueError(
                f"Layer {name!r}: specify either Lambda, or both "
                "london_lambda and thickness."
            )
        self.name = name
        self.z0 = z0
        self.london_lambda = london_lambda
        self.thickness = thickness
        self._Lambda = Lambda

    @property
    def Lambda(self) -> float:
        """Effective penetration depth ``Lambda = london_lambda**2 / thickness``."""
        if self._Lambda is not None:
            return self._Lambda
        return self.london_lambda**2 / self.thickness

    def copy(self) -> "Layer":
        return Layer(
            self.name,
            Lambda=self._Lambda,
            london_lambda=self.london_lambda,
            thickness=self.thickness,
            z0=self.z0,
        )

    def __repr__(self) -> str:
        return (
            f"Layer({self.name!r}, Lambda={self.Lambda:.3f}, "
            f"london_lambda={self.london_lambda}, thickness={self.thickness}, "
            f"z0={self.z0:.3f})"
        )
