"""superscreen_tpu_torch: the superscreen_tpu solver on PyTorch and CUDA.

The multi-film ``solve()`` and the batched ``solve_many()`` sweep of
``superscreen_tpu`` for NVIDIA Hopper GPUs, on the dense and the
low-memory path, with circulating currents, vortices, transport terminals
and a position-dependent penetration depth, and the post-processing of a
``Solution`` (interpolation, fluxoids, currents through a path, fields and
the vector potential anywhere in space, the mutual-inductance matrix): the
same host layer (geometry, meshing, FEM operators) in NumPy, the film
systems, the self-consistent coupling and the post-processing sums in
PyTorch, and the pairwise kernels written by hand in CUDA C++ (``csrc/``).  This package imports neither JAX nor ``superscreen_tpu``.
"""

from . import geometry, sources
from .convert import device_from_reference
from .device import Device, Layer, Mesh, MeshOperators, Polygon
from .parameter import Constant, Parameter
from .fluxoid import find_fluxoid_solution, make_fluxoid_polygons
from .solution import FilmSolution, Fluxoid, Solution, Vortex
from .solver import FactorizedModel, factorize_model, solve
from .sweep import SweepResult, solve_many
from .units import ureg

__all__ = [
    "Constant",
    "Device",
    "FactorizedModel",
    "FilmSolution",
    "Fluxoid",
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
    "find_fluxoid_solution",
    "geometry",
    "make_fluxoid_polygons",
    "solve",
    "solve_many",
    "sources",
    "ureg",
]
