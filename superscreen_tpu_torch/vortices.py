"""Vortex energetics: pinning and entry-barrier landscapes, vortex forces.

Counterpart of ``superscreen_tpu/vortices.py``.  In the linear London
model the free energy of one probe vortex of ``n`` flux quanta at ``r`` is

.. math::

    E(r) = n^2 E_\\mathrm{self}(r) + n\\, E_\\mathrm{int}(r), \\qquad
    E_\\mathrm{self} = \\tfrac{1}{2} \\Phi_0\\, g_\\mathrm{self}(r),\\qquad
    E_\\mathrm{int} = \\Phi_0\\, g_b(r),

where :math:`g_b` is the stream function of the vortex-free background
(screening currents, circulating, transport currents and any frozen
vortices) and :math:`g_\\mathrm{self}` is the stream a unit probe induces
at its own core: the diagonal of the film's response, the same column
``solve(vortices=[...])`` uses.  The force is the Lorentz force of the
local sheet current, ``F = -grad E``.

The self-energy over all candidate sites is the response diagonal of the
film's factorization (:func:`_response_diagonal`): for a film with
factors (LU, Cholesky or explicit inverse) a refined identity solve on
the torch device, taken in column blocks so
that no second ``(n, n)`` is ever resident; for a matrix-free film the
chunked one-hot solves or the colored-Hutchinson probing estimator of
:func:`superscreen_tpu_torch.ops.linalg.matrix_free_response_diagonal`.
The interaction term is one background ``solve``.
"""

from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from .io import new_group
from .solution import Solution, Vortex
from .units import ureg as _global_ureg

__all__ = ["VortexLandscape", "vortex_energy_landscape"]

#: Identity columns solved at once for the response diagonal of a
#: factorized film.
DIAG_BLOCK = 2048


def _response_diagonal(
    film_system,
    weights: torch.Tensor,
    diag_method: str = "auto",
    diag_options: Optional[Dict] = None,
) -> np.ndarray:
    """Per-site response ``g_self`` of a unit-flux probe for every site of
    the film system: ``d_j = -[(-A)^{-1}]_{jj}`` scaled by ``1 / w_j``.

    A film with factors of any form solves ``(-A) X = I`` in blocks of
    :data:`DIAG_BLOCK` columns with two steps of refinement
    (:func:`ops.linalg.lu_solve_refined`, the solve of the vortex path) and
    keeps each block's diagonal.  The JAX package reads an ``"inv"``
    film's ``-diag(M)`` unrefined (``superscreen_tpu/vortices.py:103-115``),
    which carries the float32 inverse's error: ~6e-6 of the self-energy
    at 6,600 unknowns, growing with the film, against the landscape's
    1e-5 bar (``tests/test_torch_factor_routes.py``; ROADMAP 3.16).  A
    matrix-free film goes to
    :func:`ops.linalg.matrix_free_response_diagonal` with ``diag_method``
    and ``diag_options``.  The result is cached on the film system.
    """
    from .ops import linalg

    if film_system.lu_piv is None and film_system.cg_op is None:
        raise ValueError("Film system has no factorization; factorize the model first.")
    cache_key = (diag_method, tuple(sorted((diag_options or {}).items())))
    cached = getattr(film_system, "_response_diag", None)
    if cached is not None and cached[0] == cache_key:
        return cached[1]
    n = len(film_system.indices)
    if film_system.cg_op is not None:
        diag = -linalg.matrix_free_response_diagonal(
            film_system.cg_op, method=diag_method, **(diag_options or {})
        )
    else:
        A = film_system.A
        diag = np.empty(n, dtype=float)
        for start in range(0, n, DIAG_BLOCK):
            rows = torch.arange(start, min(start + DIAG_BLOCK, n), device=A.device)
            k = torch.arange(len(rows), device=A.device)
            E = torch.zeros((n, len(rows)), dtype=A.dtype, device=A.device)
            E[rows, k] = 1.0
            X = linalg.lu_solve_refined(A, film_system.lu_piv, E)
            diag[start : start + len(rows)] = -X[rows, k].double().cpu().numpy()
            del E, X
    w = weights.double().cpu().numpy() if isinstance(weights, torch.Tensor) else weights
    result = diag / np.asarray(w)[film_system.indices]
    film_system._response_diag = (cache_key, result)
    return result


@dataclass(eq=False)
class VortexLandscape:
    """The free-energy landscape of a probe vortex in one film.

    The energy of a probe of ``nPhi0`` flux quanta at candidate site ``k``
    is ``nPhi0**2 * self_energy[k] + nPhi0 * interaction[k]``
    (:meth:`total`).  ``self_energy`` is mesh-regularized: the London core
    divergence is cut off at the local mesh scale.

    Args:
        film: The film the landscape lives in.
        indices: ``(m,)`` mesh site indices of the candidate sites (the
            film system's interior).
        sites: ``(m, 2)`` candidate-site coordinates.
        self_energy: ``(m,)`` self-energy of a unit probe, in ``units``.
        interaction: ``(m,)`` interaction energy of a unit probe with the
            background currents, in ``units``.
        units: Energy units of the stored arrays.
        background: The vortex-free background :class:`Solution`.
        hole_indices: ``{hole_name: site indices}`` of the film's holes.
    """

    film: str
    indices: np.ndarray
    sites: np.ndarray
    self_energy: np.ndarray
    interaction: np.ndarray
    units: str
    background: Solution
    hole_indices: Dict[str, np.ndarray] = field(default_factory=dict)
    _tri_index: object = field(default=None, repr=False)

    def total(self, nPhi0: float = 1.0) -> np.ndarray:
        """``(m,)`` total probe energy for a winding number (``-1`` for an
        antivortex)."""
        return nPhi0**2 * self.self_energy + nPhi0 * self.interaction

    def to_hdf5(self, h5group) -> None:
        """Saves the landscape, its background :class:`Solution` included,
        into ``h5group`` (an ``h5py.Group``), in the JAX package's layout."""
        h5group.attrs["film"] = self.film
        h5group.attrs["units"] = self.units
        h5group["indices"] = np.asarray(self.indices)
        h5group["sites"] = np.asarray(self.sites)
        h5group["self_energy"] = np.asarray(self.self_energy)
        h5group["interaction"] = np.asarray(self.interaction)
        holes = h5group.create_group("hole_indices")
        for name, idx in self.hole_indices.items():
            holes[name] = np.asarray(idx)
        self.background.to_hdf5(new_group(h5group, "background"))

    @classmethod
    def from_hdf5(
        cls, h5group, background: Optional[Solution] = None, torch_device="cuda"
    ) -> "VortexLandscape":
        """Reads a landscape written by :meth:`to_hdf5` (or by the JAX
        package).  Its background is the file's, post-processed on
        ``torch_device``, unless ``background`` is given."""
        if background is None:
            background = Solution.from_hdf5(h5group["background"], torch_device=torch_device)
        return cls(
            film=h5group.attrs["film"],
            indices=np.asarray(h5group["indices"]),
            sites=np.asarray(h5group["sites"]),
            self_energy=np.asarray(h5group["self_energy"]),
            interaction=np.asarray(h5group["interaction"]),
            units=h5group.attrs["units"],
            background=background,
            hole_indices={name: np.asarray(idx) for name, idx in h5group["hole_indices"].items()},
        )

    def plot(self, nPhi0: float = 1.0, ax=None, cmap="viridis", **kwargs):
        """Tripcolor plot of the total probe energy over the film; returns
        ``(fig, ax)``."""
        from .io import require

        if ax is None:
            fig, ax = require("matplotlib.pyplot").subplots(constrained_layout=True)
        else:
            fig = ax.get_figure()
        mesh = self.background.device.meshes[self.film]
        E = self.energy_map(nPhi0)
        tri = np.asarray(mesh.elements)
        keep = np.isfinite(E)[tri].all(axis=1)
        pc = ax.tripcolor(
            mesh.sites[:, 0], mesh.sites[:, 1], E, triangles=tri[keep], shading="gouraud",
            cmap=cmap, **kwargs,
        )
        cb = fig.colorbar(pc, ax=ax)
        cb.set_label(f"probe vortex energy [{self.units}]")
        ax.set_aspect("equal")
        ax.set_xlabel(f"x [{self.background.device.length_units}]")
        ax.set_ylabel(f"y [{self.background.device.length_units}]")
        return fig, ax

    def energy_map(self, nPhi0: float = 1.0) -> np.ndarray:
        """Total energy on all mesh sites of the film: 0 on the film
        boundary, NaN inside holes, :meth:`total` elsewhere."""
        mesh = self.background.device.meshes[self.film]
        E = np.zeros(len(mesh.sites), dtype=float)
        for idx in self.hole_indices.values():
            E[idx] = np.nan
        E[self.indices] = self.total(nPhi0)
        return E

    def force(
        self,
        positions: np.ndarray,
        nPhi0: float = 1.0,
        units: str = "pN",
        with_units: bool = False,
    ) -> np.ndarray:
        """Force ``F = -grad E`` on a probe vortex at ``positions``: the
        mesh vertex gradient of :meth:`energy_map`, interpolated
        barycentrically (float64, on the host).

        Args:
            positions: ``(k, 2)`` positions in device length units.
            nPhi0: Probe winding number.
            units: Force units (default pN).
            with_units: Return a Quantity array.

        Returns:
            ``(k, 2)`` forces; NaN outside the film or next to holes.
        """
        from .ops import interp

        device = self.background.device
        mesh = device.meshes[self.film]
        E = self.energy_map(nPhi0)
        # NaN-safe gradient: zero the hole sites for the product, then mask
        # every vertex whose stencil touched a hole.
        bad = ~np.isfinite(E)
        dE = mesh.vertex_gradient(np.where(bad, 0.0, E))
        if bad.any():
            touched = (mesh.vertex_gradient(bad.astype(float)) != 0.0).any(axis=1)
            dE = np.where((touched | bad)[:, None], np.nan, dE)
        if self._tri_index is None:
            self._tri_index = interp.build_triangle_index(mesh.sites, mesh.elements, "cpu")
        positions = np.atleast_2d(np.asarray(positions, dtype=float))
        F = -interp.interp_linear(self._tri_index, dE, positions).numpy()
        out = F * _global_ureg(f"1 {self.units} / {device.length_units}").to(units).magnitude
        if with_units:
            return out * _global_ureg(units)
        return out


def vortex_energy_landscape(
    device=None,
    *,
    model=None,
    film: Optional[str] = None,
    applied_field=None,
    circulating_currents: Optional[Dict[str, Union[float, str]]] = None,
    terminal_currents: Optional[Dict[str, Dict]] = None,
    vortices: Optional[Sequence[Vortex]] = None,
    field_units: str = "mT",
    current_units: str = "mA",
    iterations: int = 0,
    units: str = "eV",
    diag_method: str = "auto",
    diag_options: Optional[Dict] = None,
    torch_device="cuda",
) -> VortexLandscape:
    """The free-energy landscape of one probe vortex in a film.

    The background (applied-field screening, circulating and transport
    currents, frozen ``vortices``) is solved once; the probe's self-energy
    over every candidate site is the response diagonal of the film's
    factorization.  For multi-film devices with ``iterations > 0`` the
    background includes inter-film screening; the probe's own coupling to
    other films is neglected.

    Args:
        device: The device (omit if ``model`` is given).
        model: An existing :class:`FactorizedModel`; its frozen vortices and
            currents become part of the background.
        film: The film to scan (defaults to the only film).
        applied_field: Applied field callable (default zero).
        circulating_currents: ``{hole_name: current}`` background drives.
        terminal_currents: ``{film_name: {terminal: current}}`` drives.
        vortices: Frozen vortices contributing to the background.
        field_units: Units of ``applied_field``.
        current_units: Solver current units.
        iterations: Inter-film coupling rounds for the background solve.
        units: Energy units of the landscape (default eV).
        diag_method: The response diagonal of a matrix-free film:
            ``"exact"``, ``"probing"`` or ``"auto"`` (ignored for factorized
            films).
        diag_options: Keyword arguments of
            :func:`superscreen_tpu_torch.ops.linalg.matrix_free_response_diagonal`
            (``separation``, ``repeats``, ``chunk``, ``seed``).
        torch_device: ``"cuda"`` (default; raises without a card) or
            ``"cpu"``; a given ``model`` must live there.

    Returns:
        A :class:`VortexLandscape`.
    """
    from .solver import factorize_model, solve
    from .solver.solve import resolve_torch_device
    from .sources import ConstantField

    torch_device = resolve_torch_device(torch_device)
    if (device is None) == (model is None):
        raise ValueError("Pass exactly one of device or model.")
    if model is None:
        model = factorize_model(
            device=device,
            current_units=current_units,
            circulating_currents=circulating_currents,
            terminal_currents=terminal_currents,
            vortices=vortices,
            torch_device=torch_device,
        )
    elif circulating_currents is not None or terminal_currents is not None or vortices is not None:
        raise ValueError(
            "Background drives (circulating_currents, terminal_currents, vortices) must be "
            "baked into the model when model= is given."
        )
    device = model.device
    current_units = model.current_units
    film_names = list(device.films)
    if film is None:
        if len(film_names) > 1:
            raise ValueError(f"Multiple films {film_names}; pass film=...")
        film = film_names[0]
    if film not in film_names:
        raise KeyError(f"Film {film!r} not in device {device.name!r}.")
    film_system = model.film_systems[film]
    info = model.film_info[film]
    # The diagonal first, so that a bad diag_method fails before the
    # background solve.
    diag = _response_diagonal(
        film_system, info.weights, diag_method=diag_method, diag_options=diag_options
    )
    background = solve(
        model=model,
        applied_field=applied_field or ConstantField(0),
        field_units=field_units,
        iterations=iterations,
        torch_device=model.torch_device,
    )[-1]
    indices = np.asarray(film_system.indices)
    vortex_flux = (
        _global_ureg("Phi_0 / mu_0").to(f"{current_units} * {device.length_units}").magnitude
    )
    g_b = np.asarray(background.film_solutions[film].stream, dtype=float)[indices]
    e_unit = _global_ureg(f"1 Phi_0 * {current_units}").to(units).magnitude
    return VortexLandscape(
        film=film,
        indices=indices,
        sites=np.asarray(device.meshes[film].sites, dtype=float)[indices],
        self_energy=0.5 * e_unit * vortex_flux * diag,
        interaction=e_unit * g_b,
        units=units,
        background=background,
        hole_indices=dict(info.hole_indices),
    )
