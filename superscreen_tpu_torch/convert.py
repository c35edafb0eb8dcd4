"""Build this package's :class:`Device` from a ``superscreen_tpu`` device,
and its adjoint parameters from the JAX package's.

Only public attributes and NumPy arrays of the reference objects are read
(layers, films, holes, terminals, abstract regions and meshes; the
parameter dict's leaves), so this module does not import
``superscreen_tpu``.  Both packages then solve the identical mesh; the FEM
operators are rebuilt here from its sites and elements.
"""

import numbers

import numpy as np
import torch

from .device import Device, Layer, Mesh, Polygon
from .parameter import CompositeParameter, Parameter
from .solver.utils import torch_dtype

__all__ = ["adjoint_params_from_reference", "device_from_reference"]


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


def adjoint_params_from_reference(params, dtype=torch.float64, torch_device="cuda"):
    """The parameter dict of :class:`superscreen_tpu_torch.AdjointModel`
    from the JAX package's (``superscreen_tpu.AdjointModel.default_params``
    or an edited copy): ``{group: {key: leaf}}`` with NumPy or JAX arrays
    as leaves, each copied to a tensor of ``dtype`` (a torch or NumPy
    float dtype) on ``torch_device``."""
    from .solver.solve import resolve_torch_device

    torch_device = resolve_torch_device(torch_device)
    if not isinstance(dtype, torch.dtype):
        dtype = torch_dtype(dtype)
    return {
        group: {
            key: torch.as_tensor(np.array(leaf), dtype=dtype, device=torch_device)
            for key, leaf in leaves.items()
        }
        for group, leaves in params.items()
    }
