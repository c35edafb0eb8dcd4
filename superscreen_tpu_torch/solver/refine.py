"""High-precision (float64) solves around the float32 factorizations.

Counterpart of ``superscreen_tpu/solver/refine.py``.  The classic
mixed-precision scheme: each film's system is factorized once in float32,
assembled once more in float64, and every solve wraps the float32 factors
as a preconditioner inside float64 iterative refinement
(:func:`refined_solve`).  Each step contracts the error by about
``cond(A) * eps_f32``, so a handful of steps reach the float64 floor while
the O(n^3) work stays in float32.

The JAX package keeps the float64 side on the host in NumPy, because its
device has no float64; the H100 has, so here the float64 systems live on
the model's torch device and are assembled by the port's own assembly
(:func:`..solve_film.factorize_linear_systems` with ``assemble_only``) fed
with float64 sites, weights and Lambda: the same systems as the float32
ones at float64, not the float32 ones widened.  The JAX package's NumPy
helpers (``q_block64``, ``C_vector64``, ``q_row_sums64``, ``q_apply64``,
``coo_matvec64``, ``boundary_effective_field64``,
``biot_savart_within_film64``, ``biot_savart_film_to_film64``) are the
port's :func:`ops.kernels.q_matrix`, ``C_vector``, ``q_apply``,
:func:`ops.fem.gather_matvec`, ``boundary_effective_field``,
``biot_savart_within_film`` and ``biot_savart_film_to_film`` on float64
tensors, which launch the float64 instantiations of the CUDA kernels.

:func:`get_hp_model` wraps the float64 systems and the float32 factors in
a second :class:`FactorizedModel`; ``solve(high_precision=True)`` runs the
ordinary sweep machinery on it.  ``A64`` costs ``8 ni^2`` bytes per film on
the card beside the float32 ``A`` and its factors.
"""

import logging
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from ..ops import kernels
from ..ops.linalg import refined_solve
from .solve_film import LinearSystem, TerminalSystems, factorize_linear_systems
from .utils import make_film_info

logger = logging.getLogger("solve")

__all__ = [
    "HighPrecisionSystem",
    "build_hp_system",
    "get_hp_systems",
    "get_hp_model",
    "refined_solve",
]


@dataclass
class HighPrecisionSystem:
    """The float64 side of one film's solve, on the model's torch device.

    Args:
        indices: The film-system (interior) mesh indices.
        A64: The interior system ``Q w - Lambda lap - grad(Lambda).grad``
            restricted to ``indices``, float64, ``(ni, ni)``.
        hole_eff64: ``{hole_name: system}``: the ``(n, n_hole)``
            effective-field block (all rows, hole columns) of a dense
            film, or for a low-memory film its row sums ``(n,)`` (the
            effective field of a unit circulating current), float64.
        Lambda64: Effective penetration depth at all sites, ``(n,)``.
        weights64: Vertex areas at all sites, ``(n,)``.
        brandt_diag64: ``C + q @ w`` at all sites (the Brandt kernel's
            diagonal times ``w``), for the matrix-free self-field.
        boundary_eff64: Terminal films only: the ``(n, n_boundary)``
            effective-field block of the boundary stream.
        fwb_A64: Terminal films only: the float64 system over
            ``terminal_systems.film_without_boundary.indices``.
        fwboh_A64: Terminal films only: the float64 system over
            ``terminal_systems.film_without_boundary_or_holes.indices``
            (None when the film has no holes).
        stats: ``assembly_s``, the seconds the assembly took.
    """

    indices: np.ndarray
    A64: torch.Tensor
    hole_eff64: Dict[str, torch.Tensor]
    Lambda64: torch.Tensor
    weights64: torch.Tensor
    brandt_diag64: torch.Tensor
    boundary_eff64: Optional[torch.Tensor] = None
    fwb_A64: Optional[torch.Tensor] = None
    fwboh_A64: Optional[torch.Tensor] = None
    stats: Dict[str, float] = field(default_factory=dict)


def _assemble64(device, film_info, film_system):
    """The float64 :class:`FilmInfo`, film system, hole systems and
    terminal systems of one film (no factorization), and its
    ``brandt_diag64``."""
    name = film_info.name
    if film_system.A is None:
        raise ValueError(
            f"Film {name!r} is solved matrix-free (CG or BiCGStab) and has no "
            "materialized system; high_precision needs a factorized film "
            "(unset SUPERSCREEN_TPU_LARGE_FACTOR=cg or raise "
            "SUPERSCREEN_TPU_MAX_MATERIALIZED_N)."
        )
    torch_device = film_info.weights.device
    info64 = make_film_info(
        device=device,
        circulating_currents=film_info.circulating_currents,
        torch_device=torch_device,
        vortices=list(film_info.vortices),
        terminal_currents={name: film_info.terminal_currents} if film_info.terminal_currents else None,
        films=[name],
        dtype=np.float64,
    )[name]
    w = info64.weights
    if info64.kernel is not None:
        brandt_diag = info64.kernel.diagonal() * w
    else:
        sites = torch.as_tensor(info64.sites, device=torch_device)
        brandt_diag = kernels.C_vector(sites) + kernels.q_apply(sites, w)
    film_systems, hole_systems, terminal_systems = factorize_linear_systems(
        device, {name: info64}, assemble_only=True
    )
    # The self-field of a float64 film is matrix-free (brandt_diag64): the
    # dense kernel is not kept.
    info64.kernel = None
    return info64, film_systems[name], hole_systems[name], terminal_systems.get(name), brandt_diag


def _view(info64, film_system, hole_systems, terminal_systems, brandt_diag, seconds):
    w = info64.weights
    return HighPrecisionSystem(
        indices=np.asarray(film_system.indices),
        A64=film_system.A,
        hole_eff64={hole: system.A for hole, system in hole_systems.items()},
        Lambda64=torch.as_tensor(info64.lambda_info.Lambda[:, 0], device=w.device),
        weights64=w,
        brandt_diag64=brandt_diag,
        boundary_eff64=None if terminal_systems is None else terminal_systems.boundary.A,
        fwb_A64=None if terminal_systems is None else terminal_systems.film_without_boundary.A,
        fwboh_A64=(
            None
            if terminal_systems is None or terminal_systems.film_without_boundary_or_holes is None
            else terminal_systems.film_without_boundary_or_holes.A
        ),
        stats={"assembly_s": seconds},
    )


def build_hp_system(device, film_info, film_system, terminal_systems=None) -> HighPrecisionSystem:
    """Re-assembles one film's linear systems in float64 on the film's
    torch device, by the same assembly as the float32 ones: the interior
    system, the per-hole effective-field systems and (for a film with
    terminals) the boundary and without-boundary(/holes) systems.  A film
    without a materialized system (CG, BiCGStab) raises by name.
    ``terminal_systems`` is accepted, as by the JAX package, and not used:
    the terminal blocks are assembled from the device."""
    t0 = time.perf_counter()
    parts = _assemble64(device, film_info, film_system)
    return _view(*parts, time.perf_counter() - t0)


def _with_factors(system64: LinearSystem, system32: LinearSystem) -> LinearSystem:
    """The float64 system with the float32 system's factors."""
    return LinearSystem(A=system64.A, indices=system64.indices, lu_piv=system32.lu_piv)


def get_hp_model(model):
    """The (lazily built, cached) float64 twin of a factorized model: the
    same device, index sets and drive state, float64 film info, systems and
    film data, and the float32 model's factors (any form) as preconditioners.  The
    ordinary solve machinery runs on it; every film solve, vortex response
    column and terminal bootstrap solve is then
    :func:`refined_solve`.  Its drive state (circulating currents,
    vortices) is brought up to date with the model's on every call."""
    from ..sweep import film_sweep_data, vortex_snapshot
    from .solve import FactorizedModel

    hp = model.hp_model
    if hp is None:
        device = model.device
        film_info, film_systems, hole_systems, terminal_systems, views, diags = {}, {}, {}, {}, {}, {}
        for name, info in model.film_info.items():
            t0 = time.perf_counter()
            info64, system64, holes64, terms64, diags[name] = _assemble64(
                device, info, model.film_systems[name]
            )
            film_info[name] = info64
            hole_systems[name] = holes64
            if terms64 is not None:
                terms32 = model.terminal_systems[name]
                fwboh = None
                if terms64.film_without_boundary_or_holes is not None:
                    fwboh = _with_factors(
                        terms64.film_without_boundary_or_holes,
                        terms32.film_without_boundary_or_holes,
                    )
                terms64 = TerminalSystems(
                    film=name,
                    boundary=terms64.boundary,
                    holes=holes64,
                    film_without_boundary=_with_factors(
                        terms64.film_without_boundary, terms32.film_without_boundary
                    ),
                    film_without_boundary_or_holes=fwboh,
                )
                terminal_systems[name] = terms64
                # The film's main system is one of the terminal blocks.
                film_systems[name] = fwboh if fwboh is not None else terms64.film_without_boundary
            else:
                film_systems[name] = _with_factors(system64, model.film_systems[name])
            seconds = time.perf_counter() - t0
            views[name] = _view(info64, system64, holes64, terms64, diags[name], seconds)
            ni = len(system64.indices)
            logger.info(
                f"Assembled float64 system for film {name!r} "
                f"(ni={ni}, {8 * ni ** 2 / 1e9:.2f} GB) in {seconds:.1f}s."
            )
        hp = FactorizedModel(
            device=device,
            torch_device=model.torch_device,
            film_info=film_info,
            film_systems=film_systems,
            hole_systems=hole_systems,
            film_data={},
            circulating_currents=dict(model.circulating_currents),
            current_units=model.current_units,
            terminal_systems=terminal_systems,
            terminal_currents=model.terminal_currents,
            vortices=dict(model.vortices),
        )
        hp.film_data = {
            name: film_sweep_data(hp, name, brandt_diag=diags[name]) for name in device.films
        }
        hp.film_data_vortices = vortex_snapshot(hp)
        hp.hp_systems = views
        model.hp_model = hp
    hp.set_circulating_currents(model.circulating_currents)
    for name, info in model.film_info.items():
        hp.film_info[name].vortices = info.vortices
    hp.vortices = dict(model.vortices)
    return hp


def get_hp_systems(model) -> Dict[str, HighPrecisionSystem]:
    """The (lazily built, cached) float64 systems for every film of a
    :class:`FactorizedModel`."""
    return get_hp_model(model).hp_systems
