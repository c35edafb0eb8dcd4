"""Top-level solve orchestration and the factorized model.

Counterpart of ``superscreen_tpu/solver/solve.py`` on its device-resident
path: :func:`factorize_model` builds and LU-factorizes every film system on
the torch device, with the model's terminal currents, circulating currents
and vortices; :func:`solve` runs the initial per-film solve plus
``iterations`` rounds of exact self-consistent inter-film coupling and
returns one :class:`Solution` per round.
"""

import contextlib
import copy
import logging
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..device import Device
from ..solution import FilmSolution, Solution, Vortex
from ..sources import ConstantField
from ..sweep import (
    FilmSweepData,
    _get_sweep_data,
    _run_sweep_history,
    film_sweep_data,
    vortex_flux_quantum,
    vortex_snapshot,
)
from .solve_film import LinearSystem, TerminalSystems, factorize_linear_systems
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
    LU-factorizes the per-film systems on ``torch_device``.

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
    with highest_matmul_precision():
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


def _sample_applied_fields(
    device: Device, applied_field: Callable, field_conversion: float
) -> Dict[str, np.ndarray]:
    """Evaluates the applied field at every film's mesh sites (at the
    film's layer height), scaled into ``current_units / length_units``."""
    dtype = device.solve_dtype
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
    torch_device="cuda",
) -> List[Solution]:
    """Computes stream functions and fields for all films in a device.

    1. Solve each film given only the applied field.
    2. For ``iterations`` rounds, compute each film's screening field at
       every other film (exact Biot-Savart) and re-solve.

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
        check_inversion: Verify the solves against a float64 system; not
            supported yet (must be False).
        iterations: Number of self-consistent coupling rounds.
        return_solutions: Must be True: the solutions are not saved, so
            they are always returned.
        save_path: HDF5 path for incremental saving; not supported yet
            (must be None).
        log_level: Logging level, handed to ``logging.basicConfig``.
        progress_bar: Accepted for callers of the JAX package; the coupling
            rounds show no progress bar.
        high_precision: Float64 refinement around the float32
            factorizations; not supported yet (must be False).
        coupling: ``"exact"`` or ``"auto"`` (which means exact here);
            ``"fft"`` is not supported yet.
        torch_device: ``"cuda"`` (default; raises without a card) or
            ``"cpu"``.  A given ``model`` must live on this device.

    Returns:
        A list of ``iterations + 1`` Solutions for a multi-film device
        with ``iterations >= 1``, else one Solution.
    """
    if log_level is not None:
        logging.basicConfig(level=log_level)
    if check_inversion or high_precision:
        raise NotImplementedError(
            "check_inversion and high_precision need the float64 systems of "
            "solver/refine.py, which are not ported yet (ROADMAP item 2, certify and refine)."
        )
    if save_path is not None or not return_solutions:
        raise NotImplementedError(
            "save_path and return_solutions=False need Solution.to_hdf5, which is not "
            "ported yet (ROADMAP item 9, host conveniences)."
        )
    if coupling == "fft":
        raise NotImplementedError("coupling='fft' is not supported yet; use 'exact'.")
    if coupling not in ("auto", "exact"):
        raise ValueError(f"coupling must be 'auto' or 'exact' (got {coupling!r}).")
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
    tdtype = torch_dtype(device.solve_dtype)
    field_conversion = field_conversion_factor(
        field_units, current_units, length_units=device.length_units, ureg=device.ureg
    ).magnitude
    applied_field = applied_field or ConstantField(0)
    applied_fields = _sample_applied_fields(device, applied_field, field_conversion)
    Hz = {
        name: torch.as_tensor(applied_fields[name][None], device=torch_device)
        for name in films
    }
    I_circ = {
        name: torch.tensor(
            [[model.circulating_currents.get(h, 0.0) for h in model.film_info[name].hole_indices]],
            dtype=tdtype,
            device=torch_device,
        )
        for name in films
    }
    coupled = len(films) >= 2 and iterations >= 1
    with highest_matmul_precision():
        gs, Js, selfs, others = _run_sweep_history(
            _get_sweep_data(model),
            Hz,
            I_circ,
            vortex_flux_quantum(device, current_units),
            iterations if coupled else 0,
            2,
        )
    gs, Js, selfs, others = (
        {name: t.cpu().numpy() for name, t in d.items()} for d in (gs, Js, selfs, others)
    )
    inv = 1.0 / field_conversion
    solutions = []
    for i in range(iterations + 1 if coupled else 1):
        film_solutions = {
            name: FilmSolution(
                stream=gs[name][i, 0],
                current_density=Js[name][i, 0],
                applied_field=applied_fields[name] * inv,
                self_field=selfs[name][i, 0] * inv,
                field_from_other_films=others[name][i, 0] * inv if i > 0 else None,
            )
            for name in films
        }
        solutions.append(
            Solution(
                device=device,
                film_solutions=film_solutions,
                applied_field_func=applied_field,
                field_units=field_units,
                current_units=current_units,
                circulating_currents=model.circulating_currents,
                terminal_currents=model.terminal_currents,
                vortices=[v for vs in model.vortices.values() for v in vs],
                torch_device=torch_device,
            )
        )
    return solutions
