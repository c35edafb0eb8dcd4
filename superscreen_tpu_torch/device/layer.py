"""Layer: one plane of the device stack.

Counterpart of ``superscreen_tpu/device/layer.py``.  A layer
fixes a vertical position ``z0`` and the screening strength of its films,
given either as an effective penetration depth ``Lambda`` or as a London
penetration depth plus film thickness
(``Lambda = london_lambda**2 / thickness``).  Either may be a number or a
position-dependent :class:`superscreen_tpu_torch.Parameter`, which HDF5
files hold dill-pickled, as the JAX package's do.
"""

import numbers

from ..io import deserialize_obj, serialize_obj
from ..parameter import Parameter  # noqa: F401  (re-exported, as by the JAX package)

__all__ = ["Layer"]

# Tags of the internal screening specification.
_DIRECT = "Lambda"  # Lambda given directly
_LONDON = "london"  # (london_lambda, thickness) given


class Layer:
    """A single layer of a superconducting device.

    Args:
        name: Name of the layer.
        Lambda: Effective magnetic penetration depth of films in this layer
            (a number or a Parameter).  Mutually exclusive with
            ``london_lambda``/``thickness``.
        london_lambda: London penetration depth of films in this layer (a
            number or a Parameter).  Requires ``thickness``.
        thickness: Film thickness; requires ``london_lambda``.
        z0: Vertical position of the layer plane.
    """

    def __init__(self, name, Lambda=None, london_lambda=None, thickness=None, z0=0):
        gave_london = london_lambda is not None or thickness is not None
        if Lambda is not None and gave_london:
            raise ValueError(
                f"Layer {name!r}: Lambda is mutually exclusive with "
                "london_lambda/thickness."
            )
        if Lambda is not None:
            spec = (_DIRECT, Lambda)
        elif london_lambda is not None and thickness is not None:
            spec = (_LONDON, (london_lambda, thickness))
        else:
            raise ValueError(
                f"Layer {name!r}: specify either Lambda, or both "
                "london_lambda and thickness."
            )
        self.name = name
        self.z0 = z0
        self._spec = spec

    def _require(self, tag: str) -> None:
        if self._spec[0] != tag:
            raise AttributeError(
                "This layer is specified directly by Lambda; set Lambda instead."
                if tag == _LONDON
                else "This layer is specified by (london_lambda, thickness); "
                "set those instead of Lambda."
            )

    @property
    def london_lambda(self):
        tag, value = self._spec
        return value[0] if tag == _LONDON else None

    @london_lambda.setter
    def london_lambda(self, new) -> None:
        self._require(_LONDON)
        self._spec = (_LONDON, (new, self._spec[1][1]))

    @property
    def thickness(self):
        tag, value = self._spec
        return value[1] if tag == _LONDON else None

    @thickness.setter
    def thickness(self, new) -> None:
        self._require(_LONDON)
        self._spec = (_LONDON, (self._spec[1][0], new))

    @property
    def Lambda(self):
        """Effective penetration depth ``Lambda = london_lambda**2 / thickness``."""
        tag, value = self._spec
        if tag == _DIRECT:
            return value
        london, d = value
        return london**2 / d

    @Lambda.setter
    def Lambda(self, value) -> None:
        self._require(_DIRECT)
        self._spec = (_DIRECT, value)

    def copy(self) -> "Layer":
        return Layer(
            self.name,
            Lambda=self._spec[1] if self._spec[0] == _DIRECT else None,
            london_lambda=self.london_lambda,
            thickness=self.thickness,
            z0=self.z0,
        )

    def __eq__(self, other) -> bool:
        if not isinstance(other, Layer):
            return NotImplemented
        if self is other:
            return True
        mine = (self.name, self.z0, self.london_lambda, self.thickness, self.Lambda)
        theirs = (other.name, other.z0, other.london_lambda, other.thickness, other.Lambda)
        return all(bool(a == b) for a, b in zip(mine, theirs))

    def __repr__(self) -> str:
        def fmt(q):
            if q is None:
                return "None"
            return f"{q:.3f}" if isinstance(q, numbers.Real) else repr(q)

        return (
            f"Layer({self.name!r}, Lambda={fmt(self.Lambda)}, "
            f"london_lambda={fmt(self.london_lambda)}, "
            f"thickness={fmt(self.thickness)}, z0={self.z0:.3f})"
        )

    # -- HDF5 ---------------------------------------------------------------
    def to_hdf5(self, h5group) -> None:
        """Writes the layer into ``h5group`` (an ``h5py.Group``) in the JAX
        package's layout: a number is an attribute, a ``Parameter`` a
        dill-pickled ``<name>.pickle`` attribute."""
        h5group.attrs["name"] = self.name
        h5group.attrs["z0"] = self.z0
        tag, value = self._spec
        h5group.attrs["spec"] = tag
        if tag == _DIRECT:
            serialize_obj(h5group, value, "Lambda", attr=True)
        else:
            h5group.attrs["thickness"] = value[1]
            serialize_obj(h5group, value[0], "london_lambda", attr=True)

    @staticmethod
    def from_hdf5(h5group) -> "Layer":
        """Reads a layer written by :meth:`to_hdf5` (or by the JAX package)."""
        name = str(h5group.attrs["name"])
        z0 = float(h5group.attrs["z0"])
        has_london = (
            "london_lambda" in h5group.attrs or "london_lambda.pickle" in h5group.attrs
        )
        if has_london:
            return Layer(
                name,
                london_lambda=deserialize_obj(h5group, "london_lambda", attr=True),
                thickness=float(h5group.attrs["thickness"]),
                z0=z0,
            )
        return Layer(name, Lambda=deserialize_obj(h5group, "Lambda", attr=True), z0=z0)
