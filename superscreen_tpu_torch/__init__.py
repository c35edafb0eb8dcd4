"""superscreen_tpu_torch: the superscreen_tpu solver on PyTorch and CUDA.

The multi-film ``solve()`` and the batched ``solve_many()`` sweep of
``superscreen_tpu`` for NVIDIA Hopper GPUs, on the dense and the
low-memory path, with circulating currents, vortices, transport terminals
and a position-dependent penetration depth: the same host layer (geometry,
meshing, FEM operators) in NumPy, the film systems and the self-consistent
coupling in PyTorch, and the pairwise kernels written by hand in CUDA C++
(``csrc/``).  This package imports neither JAX nor ``superscreen_tpu``.
"""

from . import geometry, sources
from .convert import device_from_reference
from .device import Device, Layer, Mesh, MeshOperators, Polygon
from .parameter import Constant, Parameter
from .solution import FilmSolution, Solution, Vortex
from .solver import FactorizedModel, factorize_model, solve
from .sweep import SweepResult, solve_many
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
    "SweepResult",
    "Vortex",
    "device_from_reference",
    "factorize_model",
    "geometry",
    "solve",
    "solve_many",
    "sources",
    "ureg",
]
