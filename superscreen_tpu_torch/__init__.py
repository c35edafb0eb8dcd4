"""superscreen_tpu_torch: the superscreen_tpu solver on PyTorch and CUDA.

The multi-film ``solve()`` and the batched ``solve_many()`` sweep of
``superscreen_tpu`` for NVIDIA Hopper GPUs, on the dense and the
low-memory path, with circulating currents, vortices, transport terminals
and a position-dependent penetration depth, and the post-processing of a
``Solution`` (interpolation, fluxoids, currents through a path, fields and
the vector potential anywhere in space, the mutual-inductance matrix), the
float64 delivery paths (``solve_many(final_refine=...)``,
``solve(high_precision=True)``, ``certify.certify_sweep``), the SQUID
gallery and scanning SQUID microscopy (``squids``), exact or FFT
inter-film coupling (``coupling="auto"``), current imaging (``imaging``),
vortex energy landscapes (``vortex_energy_landscape``) and the
differentiable solve (``build_adjoint_model``, with ``torch.autograd``;
``squids.build_scan_forward`` on it): the
same host layer (geometry, meshing, FEM operators) in NumPy, the film
systems, the self-consistent coupling and the post-processing sums in
PyTorch, and the pairwise kernels written by hand in CUDA C++ (``csrc/``).  This package imports neither JAX nor ``superscreen_tpu``.
"""

from . import geometry, imaging, sources
from .adjoint import AdjointModel, build_adjoint_model
from .convert import adjoint_params_from_reference, device_from_reference
from .device import Device, EdgeMesh, Layer, Mesh, MeshOperators, Polygon
from .parameter import Constant, Parameter
from .fluxoid import find_fluxoid_solution, make_fluxoid_polygons
from .solution import FilmSolution, Fluxoid, Solution, Vortex
from .solver import FactorizedModel, factorize_model, solve
from .squids.scanning import build_scan_forward
from .sweep import SweepResult, solve_many
from .units import ureg
from .vortices import VortexLandscape, vortex_energy_landscape

__all__ = [
    "AdjointModel",
    "Constant",
    "Device",
    "EdgeMesh",
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
    "VortexLandscape",
    "adjoint_params_from_reference",
    "build_adjoint_model",
    "build_scan_forward",
    "device_from_reference",
    "factorize_model",
    "find_fluxoid_solution",
    "geometry",
    "imaging",
    "make_fluxoid_polygons",
    "solve",
    "solve_many",
    "sources",
    "ureg",
    "vortex_energy_landscape",
]
