"""EdgeMesh: per-edge geometry of a triangular mesh.

Counterpart of ``superscreen_tpu/device/edge_mesh.py``: the unique edges
of a triangulation with their centers, direction vectors, lengths and
boundary flags, held as NumPy arrays on the host.  The HDF5 methods take
an open ``h5py`` group; this module does not import h5py.
"""

import numpy as np

from .mesh_generation import get_edges

__all__ = ["EdgeMesh"]

# Field name -> dtype enforced on load (None = float).
_FIELDS = {
    "centers": None,
    "edges": np.int64,
    "boundary_edge_indices": np.int64,
    "directions": None,
    "edge_lengths": None,
}


class EdgeMesh:
    """A mesh composed of the edges of a triangular mesh.

    Args:
        centers: ``(x, y)`` coordinates of the edge centers.
        edges: Vertex index pairs for each edge.
        boundary_edge_indices: Indices of edges on the boundary.
        directions: Edge direction vectors.
        edge_lengths: Edge lengths.
    """

    def __init__(self, centers, edges, boundary_edge_indices, directions, edge_lengths):
        self.centers = np.asarray(centers)
        self.edges = np.asarray(edges)
        self.boundary_edge_indices = np.asarray(boundary_edge_indices, dtype=np.int64)
        self.directions = np.asarray(directions)
        self.edge_lengths = np.asarray(edge_lengths)

    def _fields(self) -> dict:
        return {name: getattr(self, name) for name in _FIELDS}

    @staticmethod
    def from_mesh(sites: np.ndarray, elements: np.ndarray) -> "EdgeMesh":
        """Builds the edge mesh for a triangulation."""
        edges, is_boundary = get_edges(elements)
        endpoints = sites[edges]  # (n_edges, 2, 2)
        vectors = endpoints[:, 1] - endpoints[:, 0]
        return EdgeMesh(
            centers=endpoints.mean(axis=1),
            edges=edges,
            boundary_edge_indices=np.nonzero(is_boundary)[0],
            directions=vectors,
            edge_lengths=np.linalg.norm(vectors, axis=1),
        )

    def to_hdf5(self, h5group) -> None:
        """Writes every field as a dataset of ``h5group`` (an ``h5py.Group``)."""
        for name, value in self._fields().items():
            h5group[name] = value

    @classmethod
    def from_hdf5(cls, h5group) -> "EdgeMesh":
        """Reads an edge mesh written by :meth:`to_hdf5`."""
        missing = [name for name in _FIELDS if name not in h5group]
        if missing:
            raise IOError(f"Could not load edge mesh: missing dataset(s) {missing}.")
        return cls(
            **{name: np.array(h5group[name], dtype=dtype) for name, dtype in _FIELDS.items()}
        )

    def copy(self) -> "EdgeMesh":
        return EdgeMesh(**{k: v.copy() for k, v in self._fields().items()})
