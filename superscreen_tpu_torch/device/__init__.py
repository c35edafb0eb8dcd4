from .device import Device
from .edge_mesh import EdgeMesh
from .layer import Layer
from .mesh import Mesh, MeshOperators
from .mesh_generation import (
    boundary_vertices,
    generate_mesh,
    get_edge_lengths,
    get_edges,
    smooth_mesh,
    triangle_areas,
    vertex_areas,
)
from .polygon import Polygon

__all__ = ["Device", "EdgeMesh", "Layer", "Mesh", "MeshOperators", "Polygon", "generate_mesh"]
