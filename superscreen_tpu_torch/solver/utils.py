"""Solver support: film metadata and unit conversion.

Counterpart of ``superscreen_tpu/solver/utils.py``.  :class:`FilmInfo`
gathers what the per-film systems need: the index sets for holes,
boundary and interior (host NumPy) and the operator blocks.  A film of at
most :data:`MAX_DENSE_KERNEL_SIZE` sites gets the dense ``Q`` and
Laplacian, assembled directly on the torch device in the solve dtype; a
larger film takes the low-memory path: no ``(n, n)`` block is built, and
its Laplacian stays a sparse COO operator.
"""

from dataclasses import dataclass
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ..device import Device, Polygon
from ..ops.fem import COO
from ..units import DimensionalityError, Quantity, ureg as default_ureg

#: Films with more mesh sites than this take the low-memory path: the
#: Brandt kernel is applied matrix-free (``ops.kernels.q_apply``) and never
#: materialized at full size.  The same threshold as the JAX package's
#: default, so the same films take the same path.
MAX_DENSE_KERNEL_SIZE = 25000

__all__ = [
    "MAX_DENSE_KERNEL_SIZE",
    "LambdaInfo",
    "FilmInfo",
    "make_film_info",
    "current_to_float",
    "currents_to_floats",
    "field_conversion_factor",
    "torch_dtype",
]


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a NumPy float dtype (float32 or float64)."""
    return {np.float32: torch.float32, np.float64: torch.float64}[np.dtype(dtype).type]


@dataclass
class LambdaInfo:
    """The effective penetration depth of a film at its mesh sites.

    Args:
        film: The film name.
        Lambda: Effective penetration depth at each mesh site, shape (n, 1).
        london_lambda: The layer's London penetration depth (optional).
        thickness: The layer's film thickness (optional).
    """

    film: str
    Lambda: np.ndarray
    london_lambda: Optional[float] = None
    thickness: Optional[float] = None


@dataclass
class FilmInfo:
    """Everything the solver needs to know about one film.

    Args:
        name: Film name.
        layer: Name of the layer containing the film.
        lambda_info: The :class:`LambdaInfo` for the film.
        interior_indices: Mesh indices inside the film, excluding the
            mesh boundary.
        boundary_indices: Boundary vertex indices.
        hole_indices: ``{hole_name: indices}`` mesh indices in each hole.
        in_hole: Boolean mask of sites inside any hole.
        circulating_currents: ``{hole_name: current}``.
        weights: Mesh vertex areas (torch, solve dtype).
        kernel: Dense Brandt kernel ``Q`` (torch, solve dtype); released
            once the film's systems are factorized.  None on the
            low-memory path.
        laplacian: Laplace-Beltrami operator: dense (torch, solve dtype)
            and released once the film's systems are factorized, or, on
            the low-memory path, the sparse COO operator (kept).
        sites: Mesh site coordinates in the solve dtype (NumPy).
        dense_kernel: False for a film on the low-memory path (more than
            :data:`MAX_DENSE_KERNEL_SIZE` sites).
    """

    name: str
    layer: str
    lambda_info: LambdaInfo
    interior_indices: np.ndarray
    boundary_indices: np.ndarray
    hole_indices: Dict[str, np.ndarray]
    in_hole: np.ndarray
    circulating_currents: Dict[str, float]
    weights: torch.Tensor
    kernel: Optional[torch.Tensor]
    laplacian: Optional[Union[torch.Tensor, COO]]
    sites: np.ndarray
    dense_kernel: bool = True


def _hole_index_sets(mesh_sites: np.ndarray, holes: List[Polygon]):
    """Per-hole mesh-index sets plus the combined in-any-hole mask."""
    hole_indices = {
        hole.name: hole.contains_points(mesh_sites, index=True) for hole in holes
    }
    in_hole = np.zeros(len(mesh_sites), dtype=bool)
    for indices in hole_indices.values():
        in_hole[indices] = True
    return hole_indices, in_hole


def make_film_info(
    *,
    device: Device,
    circulating_currents: Dict[str, float],
    torch_device,
    vortices=None,
) -> Dict[str, FilmInfo]:
    """Builds a :class:`FilmInfo` for every film in the device.  A film of
    at most :data:`MAX_DENSE_KERNEL_SIZE` sites gets the dense ``Q``
    (through the ``q_matrix`` kernel) and Laplacian, assembled on
    ``torch_device``; a larger film gets ``kernel=None`` and its COO
    Laplacian."""
    if vortices:
        raise NotImplementedError("Vortices are not supported by superscreen_tpu_torch yet.")
    if not device.meshes:
        raise ValueError(
            "The device does not have a mesh. Call device.make_mesh() to "
            "generate it."
        )
    dtype = device.solve_dtype
    tdtype = torch_dtype(dtype)
    holes_by_film = device.holes_by_film()
    film_info = {}
    for name, film in device.films.items():
        mesh = device.meshes[name]
        n = len(mesh.sites)
        dense_kernel = n <= MAX_DENSE_KERNEL_SIZE
        layer = device.layers[film.layer]
        hole_indices, in_hole = _hole_index_sets(mesh.sites, holes_by_film[name])
        boundary_indices = mesh.boundary_indices
        ops = mesh.operators
        film_info[name] = FilmInfo(
            name=name,
            layer=layer.name,
            lambda_info=LambdaInfo(
                film=name,
                Lambda=np.full((n, 1), layer.Lambda, dtype=dtype),
                london_lambda=layer.london_lambda,
                thickness=layer.thickness,
            ),
            interior_indices=np.setdiff1d(
                film.contains_points(mesh.sites, index=True), boundary_indices
            ),
            boundary_indices=boundary_indices,
            hole_indices=hole_indices,
            in_hole=in_hole,
            circulating_currents={
                hole: current
                for hole, current in circulating_currents.items()
                if hole in hole_indices
            },
            weights=torch.as_tensor(
                ops.weights.astype(dtype), device=torch_device
            ),
            kernel=ops.Q_dense(tdtype, torch_device) if dense_kernel else None,
            laplacian=(
                ops.laplacian.to_dense(tdtype, torch_device) if dense_kernel else ops.laplacian
            ),
            sites=mesh.sites.astype(dtype, copy=False),
            dense_kernel=dense_kernel,
        )
    return film_info


def current_to_float(value, ureg, current_units: str) -> float:
    """Converts a current (float, string, or Quantity) to a float in
    ``current_units``."""
    if isinstance(value, str):
        value = ureg(value)
    if isinstance(value, Quantity):
        value = value.to(current_units).magnitude
    return value


def currents_to_floats(currents: Dict, ureg, current_units: str) -> Dict[str, float]:
    """Converts a dict of currents to floats in ``current_units``."""
    return {
        key: current_to_float(value, ureg, current_units)
        for key, value in currents.items()
    }


def field_conversion_factor(
    field_units: str,
    current_units: str,
    length_units: str = "m",
    ureg=None,
) -> Quantity:
    """Conversion factor from ``field_units`` to
    ``current_units / length_units``."""
    ureg = ureg or default_ureg
    one_field_unit = ureg(field_units)
    solver_units = f"{current_units} / {length_units}"
    try:
        factor = one_field_unit.to(solver_units)
    except DimensionalityError:
        # field_units is a flux density B = mu0 * H.
        factor = (one_field_unit / ureg("mu_0")).to(solver_units)
    return factor / one_field_unit
