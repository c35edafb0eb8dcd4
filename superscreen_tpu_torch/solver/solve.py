"""Top-level solve orchestration and the factorized model.

Counterpart of ``superscreen_tpu/solver/solve.py`` on its device-resident
path: :func:`factorize_model` builds and factorizes every film system on
the torch device (:func:`superscreen_tpu_torch.ops.linalg.factor_system`), with the model's terminal currents, circulating currents
and vortices; :func:`solve` samples the applied field on the host, runs
the initial per-film solve plus ``iterations`` rounds of self-consistent
inter-film coupling (exact or FFT) on the sweep path it shares with
:func:`superscreen_tpu_torch.solve_many` (``sweep._sweep_on_device``
with every round kept, then its ``to_host``), and returns one
:class:`Solution` per round.
"""

import contextlib
import copy
import logging
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .. import tracing
from ..device import Device
from ..io import new_group
from ..solution import FilmSolution, Solution, Vortex
from ..sources import ConstantField
from ..sweep import (
    FilmSweepData,
    _check_coupling,
    _sweep_on_device,
    film_sweep_data,
    vortex_snapshot,
)
from .solve_film import LinearSystem, TerminalSystems, factorize_linear_systems, solve_film
from .utils import (
    FilmInfo,
    currents_to_floats,
    field_conversion_factor,
    get_holes_and_vortices_by_film,
    make_film_info,
    torch_dtype,
)

logger = logging.getLogger("solve")

__all__ = ["FactorizedModel", "factorize_model", "solve"]


def resolve_torch_device(torch_device) -> torch.device:
    """The torch device to compute on: ``cuda`` requires a card (there is
    no silent CPU fallback), and ``cpu`` must be asked for explicitly."""
    dev = torch.device(torch_device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "torch_device='cuda' but no CUDA device is available; pass "
                "torch_device='cpu' to run the plain PyTorch path."
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"torch_device must be a cuda or cpu device, got {dev}.")
    return dev


@contextlib.contextmanager
def highest_matmul_precision():
    """Full-precision float32 matrix products (TF32 off) for the duration:
    the iterative refinement diverges on a low-precision residual."""
    previous = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(previous)


@dataclass
class FactorizedModel:
    """A pre-factorized model: everything applied-field-independent.

    Args:
        device: The :class:`Device`.
        torch_device: The torch device holding the tensors.
        film_info: ``{film_name: FilmInfo}``.
        film_systems: ``{film_name: LinearSystem}``.
        hole_systems: ``{film_name: {hole_name: LinearSystem}}``.
        film_data: ``{film_name: FilmSweepData}``, the tensors the solve
            runs on (built for the vortices in ``film_data_vortices``; see
            :func:`superscreen_tpu_torch.sweep._get_sweep_data`).
        circulating_currents: ``{hole_name: current}``.
        current_units: The current units.
        terminal_systems: ``{film_name: TerminalSystems}``.
        terminal_currents: ``{film_name: {terminal_name: current}}``.
        vortices: ``{film_name: vortices}``.
        hp_model: The float64 twin behind ``solve(high_precision=True)``
            (built on first use by
            :func:`superscreen_tpu_torch.solver.refine.get_hp_model`).
        hp_systems: On that twin, ``{film_name: HighPrecisionSystem}``.
        fft_grids: ``{film_name: FilmGridData}`` of the FFT coupling
            (built on first use by ``sweep._attach_fft_grids``).
    """

    device: Device
    torch_device: torch.device
    film_info: Dict[str, FilmInfo]
    film_systems: Dict[str, LinearSystem]
    hole_systems: Dict[str, Dict[str, LinearSystem]]
    film_data: Dict[str, FilmSweepData]
    circulating_currents: Dict[str, float]
    current_units: str
    terminal_systems: Dict[str, TerminalSystems] = field(default_factory=dict)
    terminal_currents: Dict[str, Dict[str, float]] = field(default_factory=dict)
    vortices: Dict[str, Sequence[Vortex]] = field(default_factory=dict)
    film_data_vortices: tuple = ()
    hp_model: Optional["FactorizedModel"] = None
    hp_systems: Dict[str, object] = field(default_factory=dict)
    fft_grids: Optional[Dict[str, object]] = None

    def to_hdf5(self, h5group) -> None:
        """Saves the model, its factors included, to ``h5group`` (an
        ``h5py.Group``) in the JAX package's group layout; the tensors come
        to the host here.  The float64 twin of ``solve(high_precision=True)``
        and the FFT grids are not saved: they are rebuilt on first use."""
        h5group.attrs["current_units"] = self.current_units
        self.device.to_hdf5(new_group(h5group, "device"))
        _save_mapping(h5group, "film_info", self.film_info)
        _save_mapping(h5group, "film_systems", self.film_systems)
        holes = new_group(h5group, "hole_systems")
        for film, systems in self.hole_systems.items():
            _save_mapping(holes, film, systems)
        _save_mapping(h5group, "terminal_systems", self.terminal_systems)
        terms = new_group(h5group, "terminal_currents")
        for film, currents in self.terminal_currents.items():
            new_group(terms, film).attrs.update(currents)
        new_group(h5group, "circulating_currents").attrs.update(self.circulating_currents)
        flat_vortices = [v for vs in self.vortices.values() for v in vs]
        _save_mapping(h5group, "vortices", {str(i): v for i, v in enumerate(flat_vortices)})

    @staticmethod
    def from_hdf5(h5group, torch_device="cuda") -> "FactorizedModel":
        """Loads a model saved by :meth:`to_hdf5`, or a JAX package model
        whose films are LU-, Cholesky- or inverse-factorized, with its
        tensors on ``torch_device``
        (``"cuda"`` by default; raises without a card).

        The film data the solve runs on is rebuilt from the loaded systems:
        a dense film's ``Q`` comes from the file when the JAX package wrote
        it, else it is assembled again on ``torch_device`` exactly as
        :func:`factorize_model` assembled it.  A JAX low-memory film's hole
        vectors, padded to the shared site count, are cut to the film's."""
        torch_device = resolve_torch_device(torch_device)
        device = Device.from_hdf5(h5group["device"])
        film_info = {
            name: FilmInfo.from_hdf5(grp, torch_device)
            for name, grp in h5group["film_info"].items()
        }

        def systems(grp):
            return {key: LinearSystem.from_hdf5(sub, torch_device) for key, sub in grp.items()}

        hole_systems = {film: systems(grp) for film, grp in h5group["hole_systems"].items()}
        for film, holes in hole_systems.items():
            n = len(device.meshes[film].sites)
            for system in holes.values():
                if system.A.ndim == 1:
                    system.A = system.A[:n].contiguous()
        terminal_systems = {
            film: TerminalSystems.from_hdf5(grp, torch_device)
            for film, grp in h5group["terminal_systems"].items()
        }
        for film, terms in terminal_systems.items():
            # One set of hole systems, as factorize_model builds it.
            terms.holes = hole_systems[film]
        vortex_grp = h5group["vortices"]
        vortices = {film: [] for film in film_info}
        for i in sorted(vortex_grp, key=int):
            vortex = Vortex.from_hdf5(vortex_grp[i])
            vortices[vortex.film].append(vortex)
        with highest_matmul_precision():
            for name, info in film_info.items():
                if info.dense_kernel and info.kernel is None and name not in device.terminals:
                    info.kernel = device.meshes[name].operators.Q_dense(
                        torch_dtype(info.sites.dtype), torch_device
                    )
                info.vortices = tuple(vortices[name])
            model = FactorizedModel(
                device=device,
                torch_device=torch_device,
                film_info=film_info,
                film_systems=systems(h5group["film_systems"]),
                hole_systems=hole_systems,
                film_data={},
                circulating_currents=dict(h5group["circulating_currents"].attrs),
                current_units=str(h5group.attrs["current_units"]),
                terminal_systems=terminal_systems,
                terminal_currents={
                    film: dict(grp.attrs) for film, grp in h5group["terminal_currents"].items()
                },
                vortices={name: info.vortices for name, info in film_info.items()},
            )
            for name, terms in terminal_systems.items():
                # The film's main system is one of its terminal blocks.
                model.film_systems[name] = (
                    terms.film_without_boundary_or_holes
                    if film_info[name].hole_indices
                    else terms.film_without_boundary
                )
            model.film_data = {name: film_sweep_data(model, name) for name in device.films}
            model.film_data_vortices = vortex_snapshot(model)
        return model

    def set_circulating_currents(self, circulating_currents: Dict[str, float]) -> None:
        """Sets the circulating currents (floats in ``current_units``)
        without re-factorizing."""
        unknown = set(circulating_currents) - set(self.device.holes)
        if unknown:
            raise KeyError(
                "circulating_currents contains keys not in "
                f"self.device.holes: {sorted(unknown)!r}"
            )
        self.circulating_currents = dict(circulating_currents)
        for info in self.film_info.values():
            info.circulating_currents = {
                hole: current
                for hole, current in self.circulating_currents.items()
                if hole in info.hole_indices
            }

    def set_vortices(self, vortices: Sequence[Vortex]) -> None:
        """Sets the vortices without re-factorizing (with the same
        placement validation as :func:`factorize_model`); the next solve
        rebuilds their response columns."""
        per_film = get_holes_and_vortices_by_film(self.device, list(vortices))[1]
        for name, info in self.film_info.items():
            info.vortices = tuple(per_film[name])
        self.vortices = {name: info.vortices for name, info in self.film_info.items()}

    def copy(self) -> "FactorizedModel":
        """A copy sharing the factorizations but with independent drive
        state, so ``set_circulating_currents`` / ``set_vortices`` on the
        copy never change the original."""
        new = copy.copy(self)
        new.film_info = {name: copy.copy(info) for name, info in self.film_info.items()}
        for info in new.film_info.values():
            info.circulating_currents = dict(info.circulating_currents)
        new.circulating_currents = dict(self.circulating_currents)
        new.terminal_currents = {k: dict(v) for k, v in self.terminal_currents.items()}
        new.vortices = dict(self.vortices)
        new.film_data = dict(self.film_data)
        return new


def _save_mapping(parent, name: str, mapping: Dict):
    """Writes a ``{key: obj}`` dict of ``to_hdf5``-able objects as one
    subgroup per key under ``parent[name]``."""
    grp = new_group(parent, name)
    for key, obj in mapping.items():
        obj.to_hdf5(new_group(grp, key))
    return grp


@tracing.traced("factorize_model", entry=True)
def factorize_model(
    *,
    device: Device,
    current_units: str,
    circulating_currents: Optional[Dict[str, Union[float, str]]] = None,
    terminal_currents: Optional[Dict[str, Dict]] = None,
    vortices: Optional[Sequence[Vortex]] = None,
    torch_device="cuda",
) -> FactorizedModel:
    """Prepares the applied-field-independent part of a model: builds and
    factorizes the per-film systems on ``torch_device``
    (:func:`superscreen_tpu_torch.ops.linalg.factor_system`: LU, or above
    ``LU_MAX_N_TPU`` unknowns on the card the route of
    ``SUPERSCREEN_TPU_LARGE_FACTOR``).

    Args:
        device: The device to simulate.
        current_units: Units for currents; applied fields are converted to
            ``current_units / device.length_units``.
        circulating_currents: ``{hole_name: current}`` (floats in
            ``current_units``, or strings/Quantities with units).
        terminal_currents: ``{film_name: {terminal_name: current}}``; the
            currents of a film must sum to zero.
        vortices: Vortices in the device.
        torch_device: ``"cuda"`` (default; raises without a card) or
            ``"cpu"``.
    """
    torch_device = resolve_torch_device(torch_device)
    circulating_currents = currents_to_floats(
        circulating_currents or {}, device.ureg, current_units
    )
    terminal_currents = {
        film_name: currents_to_floats(currents, device.ureg, current_units)
        for film_name, currents in (terminal_currents or {}).items()
    }
    # Validate names up front: a misspelled hole, film or terminal key
    # would otherwise be dropped by the .get(name, 0) lookups downstream.
    unknown_holes = set(circulating_currents) - set(device.holes)
    if unknown_holes:
        raise KeyError(
            "circulating_currents contains keys not in device.holes: "
            f"{sorted(unknown_holes)!r}"
        )
    for film_name, currents in terminal_currents.items():
        if film_name not in device.terminals:
            raise KeyError(
                f"terminal_currents film {film_name!r} has no terminals "
                f"(films with terminals: {sorted(device.terminals)!r})."
            )
        terminal_names = {t.name for t in device.terminals[film_name]}
        unknown = set(currents) - terminal_names
        if unknown:
            raise KeyError(
                f"terminal_currents[{film_name!r}] contains unknown terminals "
                f"{sorted(unknown)!r} (have: {sorted(terminal_names)!r})."
            )
        # Conservation up to float rounding.
        total = sum(currents.values())
        scale = max((abs(c) for c in currents.values()), default=0.0)
        if abs(total) > 1e-9 * max(1.0, scale):
            raise ValueError(f"Terminal currents in film {film_name!r} are not conserved.")
    with highest_matmul_precision(), tracing.span("factorize.assembly"):
        film_info = make_film_info(
            device=device,
            circulating_currents=circulating_currents,
            torch_device=torch_device,
            vortices=list(vortices or []),
            terminal_currents=terminal_currents,
        )
        film_systems, hole_systems, terminal_systems = factorize_linear_systems(
            device, film_info
        )
        model = FactorizedModel(
            device=device,
            torch_device=torch_device,
            film_info=film_info,
            film_systems=film_systems,
            hole_systems=hole_systems,
            film_data={},
            circulating_currents=circulating_currents,
            current_units=current_units,
            terminal_systems=terminal_systems,
            terminal_currents=terminal_currents,
            vortices={name: info.vortices for name, info in film_info.items()},
        )
        model.film_data = {name: film_sweep_data(model, name) for name in device.films}
        model.film_data_vortices = vortex_snapshot(model)
    return model


class _SolutionSink:
    """Sinks the Solutions a solve produces: incremental HDF5 saving (group
    ``str(i)`` per solution, the device saved once at ``/device``) and the
    returned list.  Use as a context manager so the file closes even if a
    step raises."""

    def __init__(self, device: Device, save_path, keep: bool):
        self._keep = keep
        self._solutions: List[Solution] = []
        self._h5file = None
        self._count = 0
        if save_path is not None:
            from ..io import require

            self._h5file = require("h5py").File(save_path, "x")
            device.to_hdf5(new_group(self._h5file, "device"))

    def __enter__(self) -> "_SolutionSink":
        return self

    def __exit__(self, *exc) -> None:
        if self._h5file is not None:
            self._h5file.close()

    def append(self, solution: Solution) -> None:
        if self._h5file is not None:
            solution.to_hdf5(new_group(self._h5file, str(self._count)), device_path="/device")
        self._count += 1
        if self._keep:
            self._solutions.append(solution)

    def result(self) -> Optional[List[Solution]]:
        return self._solutions if self._keep else None


def _progress(items, desc: str, enabled: bool):
    """``items`` behind a tqdm bar when ``enabled`` and tqdm is installed
    (without tqdm there is no bar)."""
    if not enabled:
        return items
    try:
        from tqdm import tqdm
    except ImportError:
        return items
    return tqdm(items, desc=desc)


def _sample_applied_fields(
    device: Device, applied_field: Callable, field_conversion: float, dtype=None
) -> Dict[str, np.ndarray]:
    """Evaluates the applied field at every film's mesh sites (at the
    film's layer height), scaled into ``current_units / length_units``, in
    the device's solve dtype (or in ``dtype``)."""
    dtype = np.dtype(device.solve_dtype if dtype is None else dtype)
    out = {}
    for film, mesh in device.meshes.items():
        sites = mesh.sites
        z0 = device.layers[device.films[film].layer].z0
        values = applied_field(sites[:, 0], sites[:, 1], np.full(len(sites), z0))
        Hz = np.atleast_1d(
            np.squeeze(np.asarray(values) * field_conversion).astype(dtype, copy=False)
        )
        if Hz.shape[0] == 1:
            Hz = np.full(len(sites), Hz.item(), dtype=dtype)
        if Hz.ndim != 1:
            raise ValueError(
                f"Expected applied_field to return a 1D vector, got a {Hz.ndim}D array."
            )
        out[film] = Hz
    return out


@tracing.traced("solve", entry=True)
def solve(
    device: Optional[Device] = None,
    *,
    model: Optional[FactorizedModel] = None,
    applied_field: Optional[Callable] = None,
    circulating_currents: Optional[Dict[str, Union[float, str]]] = None,
    terminal_currents: Optional[Dict[str, Dict]] = None,
    vortices: Optional[Sequence[Vortex]] = None,
    field_units: str = "mT",
    current_units: str = "uA",
    check_inversion: bool = False,
    iterations: int = 0,
    return_solutions: bool = True,
    save_path: Optional[os.PathLike] = None,
    log_level: Optional[int] = None,
    progress_bar: bool = True,
    high_precision: bool = False,
    coupling: str = "auto",
    _solver: str = "superscreen_tpu_torch.solve",
    torch_device="cuda",
) -> List[Solution]:
    """Computes stream functions and fields for all films in a device.

    1. Solve each film given only the applied field.
    2. For ``iterations`` rounds, compute each film's screening field at
       every other film (exact Biot-Savart or the FFT transfer) and
       re-solve.

    Args:
        device: The device to simulate (or provide ``model``).
        model: A pre-factorized model (mutually exclusive with ``device``,
            ``circulating_currents``, ``terminal_currents`` and
            ``vortices``).
        applied_field: Callable ``H_z(x, y, z)`` in ``field_units``.
        circulating_currents: ``{hole_name: current}``.
        terminal_currents: ``{film_name: {terminal_name: current}}``.
        vortices: Vortices in the device.
        field_units: Units of the applied field (H or B).
        current_units: Units for currents.
        check_inversion: Verify every film solve: the float64 residual
            ``h + A g`` of the solved stream (through
            :func:`ops.kernels.residual_f64` for a float32 system) is held
            to ``numpy.allclose``'s tolerances against ``h``, and a failure
            is logged as a warning.  Matrix-free films are not checked.
        iterations: Number of self-consistent coupling rounds.
        return_solutions: Return the Solutions (else None: use with
            ``save_path``).
        save_path: HDF5 path for incremental saving: one group ``"0"``,
            ``"1"``, ... per Solution, the device once at ``/device``
            (read back with :meth:`Solution.load_solutions`; needs h5py).
        log_level: Logging level, handed to ``logging.basicConfig``.
        progress_bar: Show a tqdm bar over the Solutions as they are made
            and saved (the rounds run as one batch before), if tqdm is
            installed.
        high_precision: Solve to float64 accuracy around the float32
            factorizations (see :mod:`superscreen_tpu_torch.solver.refine`):
            float64 systems on the torch device, every film solve refined
            in float64 with the float32 factors as preconditioner, float64
            current densities, self-fields and inter-film coupling.  The
            solutions hold float64 arrays.  A film solved matrix-free
            raises.  Forces ``coupling="exact"``.
        coupling: ``"auto"`` (default), ``"exact"`` or ``"fft"``, as for
            :func:`superscreen_tpu_torch.solve_many`, whose cost model
            ``"auto"`` shares.
        _solver: The name written into each Solution's ``solver``.
        torch_device: ``"cuda"`` (default; raises without a card) or
            ``"cpu"``.  A given ``model`` must live on this device.

    Returns:
        A list of ``iterations + 1`` Solutions for a multi-film device
        with ``iterations >= 1``, else one Solution; None if
        ``return_solutions`` is False.
    """
    if log_level is not None:
        logging.basicConfig(level=log_level)
    _check_coupling(coupling)  # before the factorization, and with high_precision
    torch_device = resolve_torch_device(torch_device)
    if model is None:
        if device is None:
            raise ValueError("Either a model or a device must be provided.")
        model = factorize_model(
            device=device,
            current_units=current_units,
            circulating_currents=circulating_currents,
            terminal_currents=terminal_currents,
            vortices=vortices,
            torch_device=torch_device,
        )
    elif any(
        arg is not None
        for arg in (device, circulating_currents, terminal_currents, vortices)
    ):
        raise ValueError(
            "If model is provided, device, circulating_currents, "
            "terminal_currents and vortices must be None."
        )
    elif model.torch_device != torch_device:
        raise ValueError(
            f"The model lives on {model.torch_device}, not on {torch_device}."
        )
    device = model.device
    current_units = model.current_units
    films = list(device.films)
    solve_model, dtype = model, np.dtype(device.solve_dtype)
    if high_precision:
        from .refine import get_hp_model

        with highest_matmul_precision():
            solve_model, dtype = get_hp_model(model), np.dtype(np.float64)
    tdtype = torch_dtype(dtype)
    field_conversion = field_conversion_factor(
        field_units, current_units, length_units=device.length_units, ureg=device.ureg
    ).magnitude
    applied_field = applied_field or ConstantField(0)
    with tracing.span("sweep.inputs"):
        applied_fields = _sample_applied_fields(device, applied_field, field_conversion, dtype)
        Hz = {name: tracing.to_device(applied_fields[name][None], torch_device) for name in films}
        I_circ = {
            name: tracing.to_device(
                [[model.circulating_currents.get(h, 0.0) for h in model.film_info[name].hole_indices]],
                torch_device,
                tdtype,
            )
            for name in films
        }
    if len(films) < 2 or iterations < 1:
        iterations = 0  # nothing to couple: one round
    swept = _sweep_on_device(
        solve_model, Hz, I_circ, iterations=iterations, refine_steps=2,
        coupling="exact" if high_precision else coupling, keep_history=True,
        check_inversion=check_inversion,
    )
    with tracing.span("sweep.results"):
        gs, Js, selfs, others = swept.to_host(field_conversion)
        inv = 1.0 / field_conversion
        applied = {name: applied_fields[name] * inv for name in films}
        vortex_list = [v for vs in model.vortices.values() for v in vs]
        with _SolutionSink(device, save_path, return_solutions) as sink:
            for i in _progress(range(iterations + 1), "Solutions", progress_bar):
                film_solutions = {
                    name: FilmSolution(
                        stream=gs[name][i, 0],
                        current_density=Js[name][i, 0],
                        applied_field=applied[name],
                        self_field=selfs[name][i, 0],
                        field_from_other_films=others[name][i, 0] if i > 0 else None,
                    )
                    for name in films
                }
                sink.append(
                    Solution(
                        device=device,
                        film_solutions=film_solutions,
                        applied_field_func=applied_field,
                        field_units=field_units,
                        current_units=current_units,
                        circulating_currents=model.circulating_currents,
                        terminal_currents=model.terminal_currents,
                        vortices=vortex_list,
                        solver=_solver,
                        torch_device=torch_device,
                    )
                )
        return sink.result()
