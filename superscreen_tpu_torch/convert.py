"""Build this package's :class:`Device` from a ``superscreen_tpu`` device.

Only public attributes and NumPy arrays of the reference device are read
(layers, films, holes, abstract regions and meshes), so this module does
not import ``superscreen_tpu``.  Both packages then solve the identical
mesh; the FEM operators are rebuilt here from its sites and elements.
"""

import numpy as np

from .device import Device, Layer, Mesh, Polygon

__all__ = ["device_from_reference"]


def _polygon(ref) -> Polygon:
    return Polygon(ref.name, layer=ref.layer, points=np.asarray(ref.points))


def device_from_reference(ref_device) -> Device:
    """This package's :class:`Device` equivalent to ``ref_device`` (a
    ``superscreen_tpu.Device``), with its meshes if it has any.

    Raises:
        NotImplementedError: If the reference device has terminals.
    """
    if ref_device.terminals:
        raise NotImplementedError("Devices with terminals are not supported yet.")
    device = Device(
        ref_device.name,
        layers=[
            Layer(layer.name, Lambda=layer.Lambda, z0=layer.z0)
            for layer in ref_device.layers.values()
        ],
        films=[_polygon(p) for p in ref_device.films.values()],
        holes=[_polygon(p) for p in ref_device.holes.values()],
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
