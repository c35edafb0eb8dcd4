"""Solver support: film metadata and unit conversion.

Counterpart of ``superscreen_tpu/solver/utils.py``.  :class:`FilmInfo`
gathers what the per-film systems need: the index sets for holes,
boundary and interior (host NumPy) and the operator blocks.  A film of at
most :data:`MAX_DENSE_KERNEL_SIZE` sites gets the dense ``Q`` and
Laplacian, assembled directly on the torch device in the solve dtype; a
larger film takes the low-memory path: no ``(n, n)`` block is built, and
its Laplacian stays a sparse COO operator.  A film with transport
terminals keeps the dense blocks at any size.
"""

import logging
import numbers
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..device import Device, Polygon
from ..geometry import path_vectors
from ..ops.fem import COO
from ..parameter import Constant
from ..solution import Vortex
from ..units import DimensionalityError, Quantity, ureg as default_ureg

#: Films with more mesh sites than this take the low-memory path: the
#: Brandt kernel is applied matrix-free (``ops.kernels.q_apply``) and never
#: materialized at full size.  The same threshold as the JAX package's
#: default, so the same films take the same path.
MAX_DENSE_KERNEL_SIZE = 25000

logger = logging.getLogger("solve")

__all__ = [
    "MAX_DENSE_KERNEL_SIZE",
    "LambdaInfo",
    "FilmInfo",
    "make_film_info",
    "get_holes_and_vortices_by_film",
    "stream_from_current_density",
    "stream_from_terminal_current",
    "current_to_float",
    "currents_to_floats",
    "convert_field",
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
        london_lambda: London penetration depth at each site (optional).
        thickness: The layer's film thickness (optional).

    ``inhomogeneous`` is set when ``Lambda`` varies over the sites by more
    than 1e-6 of its smallest value.
    """

    film: str
    Lambda: np.ndarray
    london_lambda: Optional[np.ndarray] = None
    thickness: Optional[float] = None
    inhomogeneous: bool = field(init=False)

    def __post_init__(self):
        lam = np.asarray(self.Lambda)
        if (lam < 0).any():
            raise ValueError(f"Negative Lambda in film {self.film!r}.")
        floor = max(float(np.min(np.abs(lam))), float(np.finfo(float).eps))
        self.inhomogeneous = bool(float(np.ptp(lam)) > 1e-6 * floor)
        if self.inhomogeneous:
            logger.info(
                f"Inhomogeneous Lambda in film {self.film!r}, which violates "
                "the assumptions of the London model. Results may not be reliable."
            )


@dataclass
class FilmInfo:
    """Everything the solver needs to know about one film.

    Args:
        name: Film name.
        layer: Name of the layer containing the film.
        lambda_info: The :class:`LambdaInfo` for the film.
        vortices: Vortices pinned in the film.
        interior_indices: Mesh indices inside the film, excluding the
            mesh boundary.
        boundary_indices: Boundary vertex indices (CCW-ordered for a film
            with terminals).
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
            :data:`MAX_DENSE_KERNEL_SIZE` sites and no terminals).
        gradient: Dense stacked vertex gradients ``(2, n, n)`` (torch, solve
            dtype) of a dense film with inhomogeneous Lambda; released once
            the film's systems are factorized.
        gradient_coo: The ``(gx, gy)`` COO pair of a low-memory film with
            inhomogeneous Lambda.
        terminal_currents: ``{terminal_name: current}`` of a film with
            terminals.
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
    vortices: Tuple[Vortex, ...] = ()
    gradient: Optional[torch.Tensor] = None
    gradient_coo: Optional[Tuple[COO, COO]] = None
    terminal_currents: Optional[Dict[str, float]] = None


def get_holes_and_vortices_by_film(
    device: Device, vortices: List[Vortex]
) -> Tuple[Dict[str, List[Polygon]], Dict[str, List[Vortex]]]:
    """Assigns holes and vortices to films, validating vortex placement."""
    holes_by_film = device.holes_by_film()
    vortices_by_film = {film_name: [] for film_name in device.films}
    for vortex in vortices:
        if not isinstance(vortex, Vortex):
            raise TypeError(f"Expected a Vortex, but got {type(vortex)}.")
        where = (vortex.x, vortex.y)
        if not device.films[vortex.film].contains_points(where).all():
            raise ValueError(
                f"Vortex {vortex!r} is not located in film {vortex.film!r}."
            )
        for hole in holes_by_film[vortex.film]:
            if hole.contains_points(where).all():
                raise ValueError(f"Vortex {vortex} is located in hole {hole.name!r}.")
        vortices_by_film[vortex.film].append(vortex)
    return holes_by_film, vortices_by_film


def _sample_depth(value, sites: np.ndarray, dtype) -> np.ndarray:
    """Evaluates a penetration-depth spec (number or Parameter) at the mesh
    sites, returning a column vector of shape ``(n, 1)``."""
    if isinstance(value, numbers.Real):
        value = Constant(value)
    profile = np.atleast_1d(np.asarray(value(sites[:, 0], sites[:, 1]), dtype=dtype))
    if profile.shape[0] != len(sites):
        profile = np.full(len(sites), profile.item(), dtype=dtype)
    return profile[:, np.newaxis]


def _depth_info(layer, film_name: str, sites: np.ndarray, dtype, device) -> LambdaInfo:
    """Builds the :class:`LambdaInfo` for one film, logging if the thin-film
    assumption (d << london_lambda) is violated."""
    london_lambda = layer.london_lambda
    if isinstance(london_lambda, numbers.Real) and london_lambda <= layer.thickness:
        logger.info(
            f"Layer {film_name!r}: The film thickness d = {layer.thickness:.4f} "
            f"{device.length_units} is greater than or equal to the London "
            "penetration depth; the thin-film assumption that the current "
            "density is constant over the thickness may not be valid."
        )
    if london_lambda is not None:
        london_lambda = _sample_depth(london_lambda, sites, dtype)
    return LambdaInfo(
        film=film_name,
        Lambda=_sample_depth(layer.Lambda, sites, dtype),
        london_lambda=london_lambda,
        thickness=layer.thickness,
    )


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
    vortices: Optional[List[Vortex]] = None,
    terminal_currents: Optional[Dict[str, Dict[str, float]]] = None,
) -> Dict[str, FilmInfo]:
    """Builds a :class:`FilmInfo` for every film in the device.  A film of
    at most :data:`MAX_DENSE_KERNEL_SIZE` sites, or with terminals (the
    boundary correction needs explicit kernel columns), gets the dense
    ``Q`` (through the ``q_matrix`` kernel) and Laplacian, assembled on
    ``torch_device``; a larger film gets ``kernel=None`` and its COO
    Laplacian.  A film with inhomogeneous Lambda also gets its vertex
    gradients, dense or COO like its Laplacian."""
    if not device.meshes:
        raise ValueError(
            "The device does not have a mesh. Call device.make_mesh() to "
            "generate it."
        )
    dtype = device.solve_dtype
    tdtype = torch_dtype(dtype)
    holes_by_film, vortices_by_film = get_holes_and_vortices_by_film(
        device, list(vortices or [])
    )
    terminal_currents = terminal_currents or {}
    film_info = {}
    for name, film in device.films.items():
        mesh = device.meshes[name]
        n = len(mesh.sites)
        is_terminal = name in device.terminals
        dense_kernel = is_terminal or n <= MAX_DENSE_KERNEL_SIZE
        layer = device.layers[film.layer]
        lambda_info = _depth_info(layer, name, mesh.sites, dtype, device)
        hole_indices, in_hole = _hole_index_sets(mesh.sites, holes_by_film[name])
        boundary_indices = (
            device.boundary_vertices(name) if is_terminal else mesh.boundary_indices
        )
        ops = mesh.operators
        gradient = gradient_coo = None
        if lambda_info.inhomogeneous and dense_kernel:
            gradient = torch.stack(
                [
                    ops.gradient_x.to_dense(tdtype, torch_device),
                    ops.gradient_y.to_dense(tdtype, torch_device),
                ]
            )
        elif lambda_info.inhomogeneous:
            gradient_coo = (ops.gradient_x, ops.gradient_y)
        film_info[name] = FilmInfo(
            name=name,
            layer=layer.name,
            lambda_info=lambda_info,
            vortices=tuple(vortices_by_film[name]),
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
            gradient=gradient,
            gradient_coo=gradient_coo,
            terminal_currents=terminal_currents.get(name),
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


def convert_field(
    value,
    new_units,
    old_units=None,
    ureg=None,
    with_units: bool = True,
):
    """Converts between magnetic field H [current/length] and flux density
    B = mu0*H units, inserting the factor of mu0 when the dimensionalities
    differ.

    Args:
        value: Array/float (with ``old_units``), unit string, or Quantity.
        new_units: Target units.
        old_units: Units of ``value`` if it is a bare number/array.
        ureg: The unit registry to use.
        with_units: Return a Quantity instead of a bare magnitude.
    """
    ureg = ureg or default_ureg
    if isinstance(value, str):
        value = ureg(value)
    if isinstance(value, Quantity):
        old_units = value.units
    elif old_units is None:
        raise ValueError(
            "Old units must be specified if value is not a string or Quantity."
        )
    else:
        if isinstance(old_units, str):
            old_units = ureg(old_units).units
        value = Quantity(value, old_units)
    if isinstance(new_units, str):
        new_units = ureg(new_units).units
    try:
        out = value.to(new_units)
    except DimensionalityError:
        # Bridge H <-> B with one factor of mu0.  H carries a [length] in
        # its dimensionality ([current]/[length]); B does not.
        if "[length]" in dict(old_units.dimensionality):
            out = (value * ureg("mu_0")).to(new_units)
        else:
            out = (value / ureg("mu_0")).to(new_units)
    return out if with_units else out.magnitude


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


def stream_from_current_density(points: np.ndarray, J: np.ndarray) -> np.ndarray:
    """Scalar stream function along a path from a current density:
    ``g(r) = g(r0) + int (z x J) . dl``.

    ``J`` is sampled per path edge (shape ``(n - 1, 2)`` for ``n`` points);
    the returned stream has one value per edge, starting at zero.
    """
    tangents = np.diff(np.asarray(points), axis=0)
    # (z x J) . dl == Jx dy - Jy dx
    rate = J[:, 0] * tangents[:, 1] - J[:, 1] * tangents[:, 0]
    # Cumulative trapezoid with g[0] = 0.
    g = np.zeros(rate.shape[0], dtype=rate.dtype)
    np.cumsum(0.5 * (rate[1:] + rate[:-1]), out=g[1:])
    return g


def stream_from_terminal_current(points: np.ndarray, current: float) -> np.ndarray:
    """Stream function along a terminal carrying a uniformly distributed
    current perpendicular to the terminal."""
    edge_lengths, unit_normals = path_vectors(points)
    if current == 0:
        # Zero drive: identically zero stream (the normalization below
        # would be 0/0).  Reached for every undriven terminal, e.g. by the
        # per-terminal unit basis of a terminal-current sweep.
        return np.zeros(len(points) - 1)
    J = current * unit_normals / np.sum(edge_lengths)
    g = stream_from_current_density(points, J)
    return g * current / g[-1]
