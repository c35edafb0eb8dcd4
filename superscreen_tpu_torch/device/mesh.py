"""Mesh and MeshOperators.

Counterpart of ``superscreen_tpu/device/mesh.py``.  The sparse FEM
operators stay in NumPy COO form on the host; the dense Brandt kernel
``Q`` is assembled directly on the requested torch device by
:func:`superscreen_tpu_torch.ops.kernels.Q_matrix`, and is not cached:
at 20k sites it is 1.6 GB in float32, and the solver keeps only what it
derives from it.  The triangle index used for interpolation
(:meth:`Mesh.spatial_index`) is built on the host once per torch device
and cached on the mesh, which every solution of a device shares;
:meth:`Mesh.translate_sites` shifts the sites and drops what is derived
from them.  ``to_hdf5``/``from_hdf5`` write and read the JAX package's
layout (they take an open ``h5py`` group), and ``triangulation`` and
``plot`` import matplotlib when called.
"""

from copy import deepcopy
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..ops import fem
from ..io import new_group
from ..ops import kernels
from . import mesh_generation as mgen
from .edge_mesh import EdgeMesh

__all__ = ["Mesh", "MeshOperators"]

# Datasets of a mesh saved uncompressed (besides the ``edge_mesh`` group).
_MESH_FIELDS = (
    "sites",
    "elements",
    "triangle_centroids",
    "boundary_indices",
    "vertex_areas",
    "triangle_areas",
)


class Mesh:
    """A triangular mesh of a simply- or multiply-connected polygon.

    Use :meth:`Mesh.from_triangulation` to create a mesh from vertex
    coordinates and triangle indices.

    Args:
        sites: ``(n, 2)`` vertex coordinates.
        elements: ``(m, 3)`` triangle vertex indices.
        triangle_centroids: ``(m, 2)`` triangle centroids (None: derived
            from the sites and elements).
        boundary_indices: Indices of boundary vertices.
        vertex_areas: ``(n,)`` effective vertex areas.
        triangle_areas: ``(m,)`` triangle areas.
        edge_mesh: The :class:`EdgeMesh` (None: built on first use).
        build_operators: Whether to build the :class:`MeshOperators`.
    """

    def __init__(
        self,
        sites: Sequence[Tuple[float, float]],
        elements: Sequence[Tuple[int, int, int]],
        triangle_centroids: Optional[Sequence[Tuple[float, float]]],
        boundary_indices: Sequence[int],
        vertex_areas: Sequence[float],
        triangle_areas: Sequence[float],
        edge_mesh: Optional[EdgeMesh],
        build_operators: bool = True,
    ):
        self.sites = np.asarray(sites, dtype=float)
        self.elements = np.asarray(elements, dtype=np.int64)
        self.boundary_indices = np.asarray(boundary_indices, dtype=np.int64)
        self.vertex_areas = np.asarray(vertex_areas, dtype=float)
        self.triangle_areas = np.asarray(triangle_areas, dtype=float)
        if triangle_centroids is None:
            triangle_centroids = self.sites[self.elements].mean(axis=1)
        self.triangle_centroids = np.asarray(triangle_centroids, dtype=float)
        self.operators = MeshOperators.from_mesh(self) if build_operators else None
        self._spatial_index: Dict[str, object] = {}
        self._edge_mesh = edge_mesh
        self._triangulation = None

    @property
    def edge_mesh(self) -> EdgeMesh:
        """The mesh's :class:`EdgeMesh` (built on first use)."""
        if self._edge_mesh is None:
            self._edge_mesh = EdgeMesh.from_mesh(self.sites, self.elements)
        return self._edge_mesh

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
            triangle_centroids=None,
            edge_mesh=None,
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

    @property
    def triangulation(self):
        """Matplotlib triangulation of the mesh (for plots; built on first
        use, needs matplotlib)."""
        if self._triangulation is None:
            from ..io import require

            x, y = self.sites.T
            self._triangulation = require("matplotlib.tri").Triangulation(x, y, self.elements)
        return self._triangulation

    def translate_sites(self, dx: float, dy: float) -> None:
        """Shifts every site by ``(dx, dy)`` in place, with the triangle
        centroids, the edge centers and the operators' copy of the sites,
        and drops the cached triangle indices and triangulation: they are
        rebuilt at the new positions on first use."""
        shift = np.array([[dx, dy]], dtype=float)
        self.sites += shift
        self.triangle_centroids += shift
        if self.operators is not None and self.operators.sites is not self.sites:
            self.operators.sites = self.operators.sites + shift
        if self._edge_mesh is not None:
            self._edge_mesh.centers = self._edge_mesh.centers + shift
        self._spatial_index = {}
        self._triangulation = None

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

    def stats(self) -> Dict[str, Union[int, float]]:
        """A dictionary of information about the mesh."""
        lengths = self.edge_mesh.edge_lengths
        return dict(
            num_sites=len(self.sites),
            num_elements=len(self.elements),
            min_edge_length=lengths.min(),
            max_edge_length=lengths.max(),
            min_vertex_area=self.vertex_areas.min(),
            max_vertex_area=self.vertex_areas.max(),
        )

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
            triangle_centroids=None,
            boundary_indices=self.boundary_indices.copy(),
            vertex_areas=self.vertex_areas.copy(),
            triangle_areas=self.triangle_areas.copy(),
            edge_mesh=None if self._edge_mesh is None else self._edge_mesh.copy(),
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

    def plot(
        self,
        ax=None,
        show_sites: bool = False,
        show_edges: bool = True,
        site_color=None,
        edge_color="k",
        linewidth: float = 0.75,
        linestyle: str = "-",
        marker: str = ".",
    ):
        """Plots the mesh (needs matplotlib)."""
        from ..io import require

        if ax is None:
            _, ax = require("matplotlib.pyplot").subplots()
        ax.set_aspect("equal")
        x, y = self.sites.T
        if show_edges:
            ax.triplot(x, y, self.elements, color=edge_color, ls=linestyle, lw=linewidth)
        if show_sites:
            ax.plot(x, y, marker=marker, ls="", color=site_color)
        return ax

    # -- persistence -----------------------------------------------------

    def to_hdf5(self, h5group, compress: bool = True) -> None:
        """Saves the mesh to ``h5group`` (an ``h5py.Group``).  With
        ``compress=True`` only sites and elements are stored; the rest is
        rebuilt on load."""
        stored = {"sites": self.sites, "elements": self.elements}
        if not compress:
            stored.update(
                triangle_centroids=self.triangle_centroids,
                boundary_indices=self.boundary_indices,
                vertex_areas=self.vertex_areas,
                triangle_areas=self.triangle_areas,
            )
        for name, value in stored.items():
            h5group[name] = value
        if not compress:
            self.edge_mesh.to_hdf5(new_group(h5group, "edge_mesh"))

    @staticmethod
    def is_restorable(h5group) -> bool:
        """True if the group has all data needed to restore the mesh without
        recomputation."""
        return all(key in h5group for key in _MESH_FIELDS + ("edge_mesh",))

    @staticmethod
    def from_hdf5(h5group) -> "Mesh":
        """Loads a mesh from ``h5group`` (an ``h5py.Group``)."""
        if not ("sites" in h5group and "elements" in h5group):
            raise IOError("Could not load mesh due to missing data.")
        if not Mesh.is_restorable(h5group):
            return Mesh.from_triangulation(
                sites=np.array(h5group["sites"]).squeeze(),
                elements=np.array(h5group["elements"]),
            )
        return Mesh(
            sites=np.array(h5group["sites"], dtype=float),
            elements=np.array(h5group["elements"], dtype=np.int64),
            triangle_centroids=np.array(h5group["triangle_centroids"], dtype=float),
            boundary_indices=np.array(h5group["boundary_indices"], dtype=np.int64),
            vertex_areas=np.array(h5group["vertex_areas"], dtype=float),
            triangle_areas=np.array(h5group["triangle_areas"], dtype=float),
            edge_mesh=EdgeMesh.from_hdf5(h5group["edge_mesh"]),
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

    def Q(self, torch_device="cuda") -> torch.Tensor:
        """The dense Brandt kernel ``Q`` in float64 on ``torch_device``
        (``"cuda"`` by default; not cached, see :meth:`Q_dense`)."""
        from ..solver.solve import resolve_torch_device

        return self.Q_dense(torch.float64, resolve_torch_device(torch_device))

    @staticmethod
    def C_vector(points: np.ndarray, torch_device="cuda") -> np.ndarray:
        """Brandt's boundary-regularization vector of ``points`` (NumPy in
        and out, computed in ``points``' float dtype on ``torch_device``:
        ``"cuda"`` by default, raising without a card, or ``"cpu"``)."""
        from ..solver.solve import resolve_torch_device

        points = torch.as_tensor(np.asarray(points), device=resolve_torch_device(torch_device))
        return kernels.C_vector(points).cpu().numpy()

    @staticmethod
    def Q_matrix(points: np.ndarray, weights: np.ndarray, torch_device="cuda") -> np.ndarray:
        """The dense Brandt kernel of ``points`` and ``weights`` (NumPy in
        and out), assembled on ``torch_device`` by
        :func:`superscreen_tpu_torch.ops.kernels.Q_matrix`: on the card its
        ``q`` comes from the ``q_matrix`` kernel."""
        from ..solver.solve import resolve_torch_device

        torch_device = resolve_torch_device(torch_device)
        points = torch.as_tensor(np.asarray(points), device=torch_device)
        weights = torch.as_tensor(np.asarray(weights), dtype=points.dtype, device=torch_device)
        return kernels.Q_matrix(points, weights).cpu().numpy()

    def copy(self) -> "MeshOperators":
        return deepcopy(self)
