"""Mesh and MeshOperators.

Counterpart of ``superscreen_tpu/device/mesh.py``.  The sparse FEM
operators stay in NumPy COO form on the host; the dense Brandt kernel
``Q`` is assembled directly on the requested torch device by
:func:`superscreen_tpu_torch.ops.kernels.Q_matrix`, and is not cached:
at 20k sites it is 1.6 GB in float32, and the solver keeps only what it
derives from it.  The triangle index used for interpolation
(:meth:`Mesh.spatial_index`) is built on the host once per torch device
and cached on the mesh, which every solution of a device shares.
"""

from copy import deepcopy
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..ops import fem
from ..ops import kernels
from . import mesh_generation as mgen

__all__ = ["Mesh", "MeshOperators"]


class Mesh:
    """A triangular mesh of a simply- or multiply-connected polygon.

    Use :meth:`Mesh.from_triangulation` to create a mesh from vertex
    coordinates and triangle indices.

    Args:
        sites: ``(n, 2)`` vertex coordinates.
        elements: ``(m, 3)`` triangle vertex indices.
        boundary_indices: Indices of boundary vertices.
        vertex_areas: ``(n,)`` effective vertex areas.
        triangle_areas: ``(m,)`` triangle areas.
        triangle_centroids: ``(m, 2)`` triangle centroids (derived from
            the sites and elements).
        build_operators: Whether to build the :class:`MeshOperators`.
    """

    def __init__(
        self,
        sites: Sequence[Tuple[float, float]],
        elements: Sequence[Tuple[int, int, int]],
        boundary_indices: Sequence[int],
        vertex_areas: Sequence[float],
        triangle_areas: Sequence[float],
        build_operators: bool = True,
    ):
        self.sites = np.asarray(sites, dtype=float)
        self.elements = np.asarray(elements, dtype=np.int64)
        self.boundary_indices = np.asarray(boundary_indices, dtype=np.int64)
        self.vertex_areas = np.asarray(vertex_areas, dtype=float)
        self.triangle_areas = np.asarray(triangle_areas, dtype=float)
        self.triangle_centroids = self.sites[self.elements].mean(axis=1)
        self.operators = MeshOperators.from_mesh(self) if build_operators else None
        self._spatial_index: Dict[str, object] = {}

    @staticmethod
    def from_triangulation(
        sites: Sequence[Tuple[float, float]],
        elements: Sequence[Tuple[int, int, int]],
        build_operators: bool = True,
    ) -> "Mesh":
        """Creates a :class:`Mesh` from a triangulation, deriving all
        per-vertex/per-triangle geometry."""
        sites = np.asarray(sites, dtype=float).squeeze()
        elements = np.asarray(elements).squeeze()
        for arr, cols, what in (
            (sites, 2, "site coordinates"),
            (elements, 3, "elements"),
        ):
            if arr.ndim != 2 or arr.shape[1] != cols:
                raise ValueError(
                    f"The {what} must have shape (n, {cols}), "
                    f"got {arr.shape!r}."
                )
        tri_areas = mgen.triangle_areas(sites, elements)
        return Mesh(
            sites=sites,
            elements=elements,
            boundary_indices=Mesh.find_boundary_indices(elements),
            vertex_areas=mgen.vertex_areas(sites, elements, tri_areas=tri_areas),
            triangle_areas=tri_areas,
            build_operators=build_operators,
        )

    @staticmethod
    def find_boundary_indices(elements: np.ndarray) -> np.ndarray:
        """Indices of vertices on any mesh boundary (unordered)."""
        edges, is_boundary = mgen.get_edges(elements)
        return np.unique(edges[is_boundary])

    def spatial_index(self, torch_device):
        """Uniform-grid triangle index on ``torch_device`` for interpolation
        (:func:`superscreen_tpu_torch.ops.interp.build_triangle_index`),
        built on first use and cached per device.  It is float64 whatever
        the solve dtype (see :mod:`superscreen_tpu_torch.ops.interp`)."""
        from ..ops import interp

        key = str(torch.device(torch_device))
        if key not in self._spatial_index:
            self._spatial_index[key] = interp.build_triangle_index(
                self.sites, self.elements, torch_device
            )
        return self._spatial_index[key]

    def vertex_gradient(self, values: np.ndarray) -> np.ndarray:
        """Per-vertex gradient ``(n, 2)`` of per-vertex scalar ``values``
        via the vertex-gradient operators (host NumPy)."""
        ops = self.operators
        if ops is None:
            raise RuntimeError("Mesh was built without operators.")
        values = np.asarray(values, dtype=float)
        columns = [
            np.bincount(op.rows, weights=op.vals * values[op.cols], minlength=op.shape[0])
            for op in (ops.gradient_x, ops.gradient_y)
        ]
        return np.stack(columns, axis=-1)

    def closest_site(self, xy: Tuple[float, float]) -> int:
        """Index of the mesh site closest to ``(x, y)``."""
        offsets = self.sites - np.atleast_2d(xy)
        return int(np.einsum("ij,ij->i", offsets, offsets).argmin())

    def copy(self) -> "Mesh":
        """A deep copy: arrays and operators are copied, the cached
        triangle indices are not carried over."""
        clone = Mesh(
            sites=self.sites.copy(),
            elements=self.elements.copy(),
            boundary_indices=self.boundary_indices.copy(),
            vertex_areas=self.vertex_areas.copy(),
            triangle_areas=self.triangle_areas.copy(),
            build_operators=False,
        )
        clone.operators = deepcopy(self.operators)
        return clone

    def smooth(self, iterations: int, build_operators: bool = True) -> "Mesh":
        """Laplacian smoothing of the interior vertices."""
        if not iterations:
            return self
        sites, elements = mgen.smooth_mesh(self.sites, self.elements, iterations)
        return Mesh.from_triangulation(
            sites, elements, build_operators=build_operators
        )


class MeshOperators:
    """Finite-element operators for a :class:`Mesh`.

    Args:
        weights: Effective vertex areas, shape ``(n,)``.
        sites: Mesh vertex coordinates (kept to build ``Q`` on demand).
        gradient_x, gradient_y: Vertex gradient operators (COO, ``(n, n)``).
        gradient_tri_x, gradient_tri_y: Triangle gradient operators (COO,
            ``(m, n)``).
        laplacian: Laplace-Beltrami operator (COO, ``(n, n)``).
    """

    def __init__(
        self,
        *,
        weights: np.ndarray,
        sites: np.ndarray,
        gradient_x: fem.COO,
        gradient_y: fem.COO,
        gradient_tri_x: fem.COO,
        gradient_tri_y: fem.COO,
        laplacian: fem.COO,
    ):
        self.weights = weights
        self.sites = sites
        self.gradient_x = gradient_x
        self.gradient_y = gradient_y
        self.gradient_tri_x = gradient_tri_x
        self.gradient_tri_y = gradient_tri_y
        self.laplacian = laplacian

    @staticmethod
    def from_mesh(mesh: Mesh) -> "MeshOperators":
        """Builds all operators for a mesh."""
        sites, elements = mesh.sites, mesh.elements
        gx, gy = fem.gradient_vertices_coo(
            sites, elements, areas=mesh.triangle_areas
        )
        gtx, gty = fem.gradient_triangles_coo(
            sites, elements, areas=mesh.triangle_areas
        )
        return MeshOperators(
            weights=mesh.vertex_areas,
            sites=sites,
            gradient_x=gx,
            gradient_y=gy,
            gradient_tri_x=gtx,
            gradient_tri_y=gty,
            laplacian=fem.build_laplacian_coo(
                sites, elements, masses=mesh.vertex_areas
            ),
        )

    def Q_dense(self, dtype: torch.dtype, torch_device) -> torch.Tensor:
        """Dense Brandt kernel ``Q`` in ``dtype``, assembled on
        ``torch_device`` (the site coordinates and weights are the only
        host-to-device transfer)."""
        sites = torch.as_tensor(self.sites, dtype=dtype, device=torch_device)
        weights = torch.as_tensor(self.weights, dtype=dtype, device=torch_device)
        return kernels.Q_matrix(sites, weights)
