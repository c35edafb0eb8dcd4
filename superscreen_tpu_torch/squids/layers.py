"""Wiring-layer stacks for the real SQUID susceptometer layouts.

IBM and Hypres susceptometers share the same three-metal-layer structure
(W2 / W1 / BE separated by insulators I2 / I1); only the default
thicknesses and London penetration depths differ.  Reference:
``docs/notebooks/squids/ibm/layers.py:16-54`` and
``docs/notebooks/squids/hypres/layers.py:6-52`` (the stack follows
arXiv:1605.09483, Fig. 8).
"""

from typing import List

from ..device import Layer

__all__ = ["ibm_squid_layers", "hypres_squid_layers"]


def _trilayer(
    align: str,
    london_lambda: float,
    z0: float,
    d_BE: float,
    d_I1: float,
    d_W1: float,
    d_I2: float,
    d_W2: float,
) -> List[Layer]:
    """Build the W2/W1/BE stack with the 2D model plane of each metal layer
    placed at its bottom, middle, or top."""
    if align == "middle":
        # Mid-plane model: successive planes are separated by the insulator
        # plus half of each adjacent metal thickness.
        z_W2 = z0 + d_W2 / 2
        z_W1 = z_W2 + d_I2 + d_W1 / 2
        z_BE = z_W1 + d_I1 + d_BE / 2
    elif align in ("bottom", "top"):
        # Physical metal-layer bottoms; "top" adds each layer's thickness.
        lift = {"bottom": 0.0, "top": 1.0}[align]
        z_W2 = z0 + lift * d_W2
        z_W1 = z0 + d_W2 + d_I2 + lift * d_W1
        z_BE = z0 + d_W2 + d_I2 + d_W1 + d_I1 + lift * d_BE
    else:
        raise ValueError(
            f"align must be 'top', 'middle', or 'bottom', got {align!r}."
        )
    return [
        Layer("W2", london_lambda=london_lambda, thickness=d_W2, z0=z_W2),
        Layer("W1", london_lambda=london_lambda, thickness=d_W1, z0=z_W1),
        Layer("BE", london_lambda=london_lambda, thickness=d_BE, z0=z_BE),
    ]


def ibm_squid_layers(
    align: str = "middle",
    london_lambda: float = 0.08,
    z0: float = 0.0,
    d_BE: float = 0.16,
    d_I1: float = 0.15,
    d_W1: float = 0.10,
    d_I2: float = 0.13,
    d_W2: float = 0.20,
) -> List[Layer]:
    """The IBM susceptometer wiring stack (thicknesses in microns)."""
    return _trilayer(align, london_lambda, z0, d_BE, d_I1, d_W1, d_I2, d_W2)


def hypres_squid_layers(
    align: str = "middle",
    london_lambda: float = 0.09,
    z0: float = 0.0,
    d_BE: float = 0.20,
    d_I1: float = 0.20,
    d_W1: float = 0.20,
    d_I2: float = 0.15,
    d_W2: float = 0.135,
) -> List[Layer]:
    """The Hypres susceptometer wiring stack (thicknesses in microns)."""
    return _trilayer(align, london_lambda, z0, d_BE, d_I1, d_W1, d_I2, d_W2)
