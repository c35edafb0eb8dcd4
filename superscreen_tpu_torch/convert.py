"""Build this package's :class:`Device` from a ``superscreen_tpu`` device.

Only public attributes and NumPy arrays of the reference device are read
(layers, films, holes, terminals, abstract regions and meshes), so this
module does not import ``superscreen_tpu``.  Both packages then solve the
identical mesh; the FEM operators are rebuilt here from its sites and
elements.
"""

import numbers

import numpy as np

from .device import Device, Layer, Mesh, Polygon
from .parameter import CompositeParameter, Parameter

__all__ = ["device_from_reference"]


def _polygon(ref) -> Polygon:
    return Polygon(ref.name, layer=ref.layer, points=np.asarray(ref.points))


def _depth(ref):
    """A penetration depth of the reference layer as this package's type:
    a number stays, a parameter (or an expression tree of parameters) is
    rebuilt around the same functions and bound keyword arguments."""
    if ref is None or isinstance(ref, numbers.Real):
        return ref
    if hasattr(ref, "operator"):
        return CompositeParameter(_depth(ref.left), _depth(ref.right), ref.operator)
    return Parameter(ref.func, **ref.kwargs)


def _layer(ref) -> Layer:
    if ref.london_lambda is not None:
        return Layer(
            ref.name,
            london_lambda=_depth(ref.london_lambda),
            thickness=ref.thickness,
            z0=ref.z0,
        )
    return Layer(ref.name, Lambda=_depth(ref.Lambda), z0=ref.z0)


def device_from_reference(ref_device) -> Device:
    """This package's :class:`Device` equivalent to ``ref_device`` (a
    ``superscreen_tpu.Device``), with its terminals and, if it has any,
    its meshes."""
    device = Device(
        ref_device.name,
        layers=[_layer(layer) for layer in ref_device.layers.values()],
        films=[_polygon(p) for p in ref_device.films.values()],
        holes=[_polygon(p) for p in ref_device.holes.values()],
        terminals={
            film: [_polygon(t) for t in terms]
            for film, terms in ref_device.terminals.items()
        },
        abstract_regions=[_polygon(p) for p in ref_device.abstract_regions.values()],
        length_units=ref_device.length_units,
        solve_dtype=np.dtype(ref_device.solve_dtype),
    )
    if ref_device.meshes:
        device.meshes = {
            name: Mesh.from_triangulation(
                np.asarray(mesh.sites), np.asarray(mesh.elements)
            )
            for name, mesh in ref_device.meshes.items()
        }
    return device
