from .device import Device
from .edge_mesh import EdgeMesh
from .layer import Layer
from .mesh import Mesh, MeshOperators
from .mesh_generation import generate_mesh
from .polygon import Polygon

__all__ = ["Device", "EdgeMesh", "Layer", "Mesh", "MeshOperators", "Polygon", "generate_mesh"]
