"""Applied-field sources.

Every source here returns a :class:`superscreen_tpu_torch.parameter.Parameter`
evaluating ``H_z(x, y, z)`` at mesh sites.  Constants, dipoles, monopoles
and the Pearl vortex are closed-form NumPy expressions on the host; the
field of a sheet current (:func:`biot_savart_2d`, :func:`SheetCurrentField`)
is a pairwise sum on the torch device.
"""

from .constant import ConstantField
from .current import SheetCurrentField, biot_savart_2d
from .dipole import DipoleField, dipole_distribution, dipole_field
from .vortex import (
    MonopoleField,
    PearlVortexField,
    VortexField,
    monopole,
    pearl_vortex,
)

__all__ = [
    "ConstantField",
    "DipoleField",
    "MonopoleField",
    "PearlVortexField",
    "SheetCurrentField",
    "VortexField",
    "biot_savart_2d",
    "dipole_distribution",
    "dipole_field",
    "monopole",
    "pearl_vortex",
]
