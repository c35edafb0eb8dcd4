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
``squids.build_scan_forward`` on it), HDF5 files of devices, solutions and
factorized models in the JAX package's layout (``to_hdf5``/``from_hdf5``,
``solve(save_path=...)``), device transforms, an opt-in mesh cache shared
with the JAX package, and plots (``visualization``): the
same host layer (geometry, meshing, FEM operators) in NumPy, with
Delaunay triangulation and point-in-polygon tests in a C++ core
(``native``, built with the host compiler at first use), the film
systems, the self-consistent coupling and the post-processing sums in
PyTorch, and the pairwise kernels written by hand in CUDA C++ (``csrc/``).  This package imports neither JAX nor ``superscreen_tpu``.
"""

from . import geometry, imaging, io, sources
from .about import version_dict, version_table
from .adjoint import AdjointModel, build_adjoint_model
from .convert import adjoint_params_from_reference, device_from_reference
from .device import Device, EdgeMesh, Layer, Mesh, MeshOperators, Polygon
from .device.mesh_generation import generate_mesh, smooth_mesh
from . import distance, fem
from .parameter import CompositeParameter, Constant, Parameter
from .fluxoid import find_fluxoid_solution, make_fluxoid_polygons
from .solution import FilmSolution, Fluxoid, Solution, Vortex
from .solver import FactorizedModel, convert_field, factorize_model, solve
from .squids.scanning import build_scan_forward
from .sweep import SweepResult, solve_many
from .units import ureg
from .version import __version__, __version_info__
from .visualization import (
    auto_grid,
    cross_section,
    grids_to_vecs,
    non_gui_backend,
    plot_currents,
    plot_field_at_positions,
    plot_fields,
    plot_mutual_inductance,
    plot_polygon_flux,
    plot_streams,
)
from .vortices import VortexLandscape, vortex_energy_landscape

__all__ = [
    "AdjointModel",
    "CompositeParameter",
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
    "__version__",
    "auto_grid",
    "build_scan_forward",
    "convert_field",
    "cross_section",
    "device_from_reference",
    "distance",
    "factorize_model",
    "fem",
    "find_fluxoid_solution",
    "generate_mesh",
    "geometry",
    "grids_to_vecs",
    "imaging",
    "io",
    "make_fluxoid_polygons",
    "non_gui_backend",
    "plot_currents",
    "plot_field_at_positions",
    "plot_fields",
    "plot_mutual_inductance",
    "plot_polygon_flux",
    "plot_streams",
    "smooth_mesh",
    "solve",
    "solve_many",
    "sources",
    "ureg",
    "version_dict",
    "version_table",
    "vortex_energy_landscape",
]
