"""superscreen_tpu_torch: the superscreen_tpu solver on PyTorch and CUDA.

The dense multi-film ``solve()`` path of ``superscreen_tpu`` for NVIDIA
Hopper GPUs: the same host layer (geometry, meshing, FEM operators) in
NumPy, the film systems and the self-consistent coupling in PyTorch, and
the pairwise kernels written by hand in CUDA C++ (``csrc/``).  This
package imports neither JAX nor ``superscreen_tpu``.
"""

from . import geometry, sources
from .convert import device_from_reference
from .device import Device, Layer, Mesh, MeshOperators, Polygon
from .parameter import Constant, Parameter
from .solution import FilmSolution, Solution
from .solver import FactorizedModel, factorize_model, solve
from .units import ureg

__all__ = [
    "Constant",
    "Device",
    "FactorizedModel",
    "FilmSolution",
    "Layer",
    "Mesh",
    "MeshOperators",
    "Parameter",
    "Polygon",
    "Solution",
    "device_from_reference",
    "factorize_model",
    "geometry",
    "solve",
    "sources",
    "ureg",
]
