"""Visualization of solutions (matplotlib, host-side).

Counterpart of ``superscreen_tpu/visualization.py``: tripcolor maps of
stream functions, fields, and current densities; arbitrary-plane field
maps; mutual-inductance and polygon-flux convergence plots; shared
color-limit logic with IQR auto-ranging; and cross-section line cuts.
The NumPy helpers (:func:`auto_range_iqr`, :func:`grids_to_vecs`,
:func:`setup_color_limits`, :func:`make_lims`, :func:`cross_section`) run
without matplotlib; every function that draws imports it when called and
raises ``ImportError`` naming it if it is absent.
"""

from contextlib import contextmanager
from typing import Dict, List, Literal, Optional, Sequence, Tuple, Union

import numpy as np

from .io import require
from .solution import Solution
from .units import Quantity

__all__ = [
    "non_gui_backend",
    "auto_range_iqr",
    "auto_grid",
    "grids_to_vecs",
    "setup_color_limits",
    "cross_section",
    "plot_streams_layer",
    "plot_streams",
    "plot_fields",
    "plot_currents",
    "plot_field_at_positions",
    "plot_mutual_inductance",
    "plot_polygon_flux",
]

InterpolatorType = Literal["linear", "cubic"]


@contextmanager
def non_gui_backend():
    """Context manager running matplotlib with the non-GUI Agg backend."""
    plt = require("matplotlib.pyplot")
    try:
        old_backend = plt.get_backend()
        plt.switch_backend("Agg")
        yield
    finally:
        plt.switch_backend(old_backend)


def auto_range_iqr(
    data_array: np.ndarray,
    cutoff_percentile: Union[float, Tuple[float, float]] = 1,
) -> Tuple[float, float]:
    """Color limits from the interquartile range, robust to outliers.

    Args:
        data_array: The data to analyze.
        cutoff_percentile: Percentile(s) beyond which outliers are clipped.

    Returns:
        ``(vmin, vmax)``.
    """
    if isinstance(cutoff_percentile, tuple):
        t = cutoff_percentile[0]
        b = cutoff_percentile[1]
    else:
        t = b = cutoff_percentile
    z = np.asarray(data_array).flatten()
    z = z[np.isfinite(z)]
    if len(z) == 0:
        return 0.0, 1.0
    zmax = np.max(z)
    zmin = np.min(z)
    zrange = zmax - zmin
    pmin, q3, q1, pmax = np.percentile(z, [b, 75, 25, 100 - t])
    iqr = q3 - q1
    # If the data looks roughly Gaussian, don't clip.
    if zrange == 0 or (iqr > 0 and zrange / iqr < 8):
        return float(zmin), float(zmax)
    vmin = max(q1 - 1.5 * iqr, zmin)
    vmax = min(q3 + 1.5 * iqr, zmax)
    vmin = min(vmin, pmin)
    vmax = max(vmax, pmax)
    return float(vmin), float(vmax)


def auto_grid(
    num_plots: int,
    max_cols: int = 3,
    delaxes: bool = True,
    **kwargs,
) -> Tuple["matplotlib.figure.Figure", np.ndarray]:
    """Creates a grid of at least ``num_plots`` subplots.

    Args:
        num_plots: Number of plots needed.
        max_cols: Maximum number of columns.
        delaxes: Remove unused axes.
        kwargs: Passed to ``plt.subplots``.

    Returns:
        ``(fig, axes)`` with axes an ndarray.
    """
    plt = require("matplotlib.pyplot")
    num_plots = int(num_plots)
    ncols = max(1, min(int(max_cols), num_plots))
    nrows = -(-num_plots // ncols)  # ceil division
    fig, axes = plt.subplots(nrows, ncols, **kwargs)
    axes = np.atleast_1d(np.asarray(axes, dtype=object))
    if delaxes:
        # Trailing cells of the grid beyond num_plots are blank fill.
        for unused in axes.flat[num_plots:]:
            unused.remove()
    return fig, axes


def grids_to_vecs(
    xgrid: np.ndarray, ygrid: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Extracts coordinate vectors from 2D meshgrids."""
    return xgrid[0, :], ygrid[:, 0]


def setup_color_limits(
    dict_of_arrays: Dict[str, np.ndarray],
    vmin: Optional[float] = None,
    vmax: Optional[float] = None,
    share_color_scale: bool = False,
    symmetric_color_scale: bool = False,
    auto_range_cutoff: Optional[Union[float, Tuple[float, float]]] = None,
) -> Dict[str, Tuple[float, float]]:
    """Color limits for a dict of arrays.

    Args:
        dict_of_arrays: ``{name: array}``.
        vmin, vmax: Explicit limits applied to all arrays.
        share_color_scale: Use one scale for all arrays.
        symmetric_color_scale: Force limits symmetric about zero.
        auto_range_cutoff: IQR auto-range cutoff percentile.

    Returns:
        ``{name: (vmin, vmax)}``.
    """
    has_min, has_max = vmin is not None, vmax is not None
    if has_min != has_max:
        raise ValueError("If either vmin or vmax is provided, both must be provided.")
    if has_min:
        # Explicit limits override every other option.
        return dict.fromkeys(dict_of_arrays, (vmin, vmax))

    def one_array_limits(array: np.ndarray) -> Tuple[float, float]:
        if auto_range_cutoff is not None:
            return auto_range_iqr(array, cutoff_percentile=auto_range_cutoff)
        array = np.asarray(array)
        return float(np.nanmin(array)), float(np.nanmax(array))

    clims = {name: one_array_limits(arr) for name, arr in dict_of_arrays.items()}

    if share_color_scale and clims:
        lows, highs = zip(*clims.values())
        clims = dict.fromkeys(clims, (min(lows), max(highs)))

    if symmetric_color_scale:
        for name, (lo, hi) in clims.items():
            bound = max(abs(lo), abs(hi))
            clims[name] = (-bound, bound)

    return clims


def make_lims(vals: np.ndarray, buffer: float = 0.0) -> Tuple[float, float]:
    """Min/max of an array with a relative buffer."""
    vmin, vmax = np.min(vals), np.max(vals)
    d = (vmax - vmin) * buffer
    return vmin - d, vmax + d


def cross_section(
    dataset_coords: np.ndarray,
    dataset_values: np.ndarray,
    cross_section_coords: Union[np.ndarray, Sequence[np.ndarray]],
    interp_method: InterpolatorType = "linear",
) -> Tuple[List[np.ndarray], List[np.ndarray], List[np.ndarray]]:
    """Takes cross sections of a scattered 2D dataset along given paths.

    Args:
        dataset_coords: ``(n, 2)`` data coordinates.
        dataset_values: ``(n,)`` data values.
        cross_section_coords: One or more ``(m, 2)`` paths.
        interp_method: "linear" or "cubic".

    Returns:
        Lists of (path coords, distance along path, interpolated values).
    """
    from scipy.interpolate import CloughTocher2DInterpolator, LinearNDInterpolator

    interp_type = {
        "linear": LinearNDInterpolator,
        "cubic": CloughTocher2DInterpolator,
    }[interp_method]
    if not isinstance(cross_section_coords, (list, tuple)):
        cross_section_coords = [cross_section_coords]
    cross_section_coords = [np.atleast_2d(c) for c in cross_section_coords]
    for i, arr in enumerate(cross_section_coords):
        if arr.ndim != 2 or arr.shape[-1] != 2:
            raise ValueError(
                f"Invalid shape for coordinate array {i}: {arr.shape}."
            )
    interpolator = interp_type(dataset_coords, dataset_values)
    paths = []
    cross_sections = []
    for c in cross_section_coords:
        paths.append(
            np.concatenate(
                [[0], np.cumsum(np.linalg.norm(np.diff(c, axis=0), axis=1))]
            )
        )
        cross_sections.append(interpolator(c[:, 0], c[:, 1]))
    return cross_section_coords, paths, cross_sections


def _plot_scalar_per_film(
    solution: Solution,
    films: Optional[Union[List[str], str]],
    get_array,
    units_label: str,
    title: str,
    max_cols: int,
    cmap: str,
    colorbar: bool,
    shading: str,
    auto_range_cutoff,
    share_color_scale: bool,
    symmetric_color_scale: bool,
    vmin,
    vmax,
    cross_section_coords=None,
    **kwargs,
) -> Tuple["matplotlib.figure.Figure", np.ndarray]:
    device = solution.device
    if films is None:
        films = list(device.films)
    if isinstance(films, str):
        films = [films]
    num_plots = len(films) + (1 if cross_section_coords is not None else 0)
    fig, axes = auto_grid(
        num_plots, max_cols=max_cols, constrained_layout=True, **kwargs
    )
    arrays = {name: get_array(name) for name in films}
    clim_dict = setup_color_limits(
        arrays,
        vmin=vmin,
        vmax=vmax,
        share_color_scale=share_color_scale,
        symmetric_color_scale=symmetric_color_scale,
        auto_range_cutoff=auto_range_cutoff,
    )
    xs_ax = None
    axes_list = list(np.atleast_1d(axes).flat)
    if cross_section_coords is not None:
        xs_ax = axes_list[-1]
    for ax, name in zip(axes_list, films):
        mesh = device.meshes[name]
        array = arrays[name]
        lo, hi = clim_dict[name]
        im = ax.tripcolor(
            mesh.triangulation,
            array,
            cmap=cmap,
            shading=shading,
            vmin=lo,
            vmax=hi,
        )
        ax.set_title(f"{title}\n{name}")
        ax.set_aspect("equal")
        ax.set_xlabel(f"$x$ [{device.length_units}]")
        ax.set_ylabel(f"$y$ [{device.length_units}]")
        if colorbar:
            cbar = fig.colorbar(im, ax=ax)
            cbar.set_label(units_label)
        if cross_section_coords is not None:
            coords, paths, sections = cross_section(
                mesh.sites, array, cross_section_coords
            )
            for i, (c, path, sect) in enumerate(zip(coords, paths, sections)):
                color = f"C{i % 10}"
                ax.plot(*c.T, "--", color=color, lw=2)
                ax.plot(*c[0], "o", color=color)
                ax.plot(*c[-1], "s", color=color)
                xs_ax.plot(path, sect, color=color, lw=2)
                xs_ax.plot(path[0], sect[0], "o", color=color)
                xs_ax.plot(path[-1], sect[-1], "s", color=color)
            xs_ax.grid(True)
            xs_ax.set_xlabel(f"Distance along cut [{device.length_units}]")
            xs_ax.set_ylabel(units_label)
    return fig, np.atleast_1d(axes)


def plot_streams_layer(
    solution: Solution,
    film: str,
    units: Optional[str] = None,
    ax: Optional["matplotlib.axes.Axes"] = None,
    cmap: str = "coolwarm",
    levels: int = 101,
    colorbar: bool = True,
    **kwargs,
) -> Tuple["matplotlib.axes.Axes", Optional[object]]:
    """Plots the stream function for a single film.

    Args:
        solution: The solution.
        film: The film name.
        units: Current units for the stream function.
        ax: Axes to plot into.
        cmap: Colormap.
        levels: Number of contour levels.
        colorbar: Add a colorbar.

    Returns:
        ``(ax, colorbar)``.
    """
    plt = require("matplotlib.pyplot")
    if ax is None:
        _, ax = plt.subplots(**kwargs)
    device = solution.device
    units = units or solution.current_units
    mesh = device.meshes[film]
    stream = Quantity(
        solution.film_solutions[film].stream, solution.current_units
    ).to(units).magnitude
    im = ax.tricontourf(mesh.triangulation, stream, cmap=cmap, levels=levels)
    ax.set_aspect("equal")
    cbar = None
    if colorbar:
        cbar = ax.get_figure().colorbar(im, ax=ax)
        cbar.set_label(f"$g$ [{units}]")
    return ax, cbar


def plot_streams(
    solution: Solution,
    films: Optional[Union[List[str], str]] = None,
    units: Optional[str] = None,
    max_cols: int = 3,
    cmap: str = "coolwarm",
    colorbar: bool = True,
    shading: Literal["flat", "gouraud"] = "flat",
    auto_range_cutoff: Optional[Union[float, Tuple[float, float]]] = None,
    share_color_scale: bool = False,
    symmetric_color_scale: bool = True,
    vmin: Optional[float] = None,
    vmax: Optional[float] = None,
    **kwargs,
) -> Tuple["matplotlib.figure.Figure", np.ndarray]:
    """Plots the stream function of each film (tripcolor maps).

    Args:
        solution: The solution to plot.
        films: Film name(s) (defaults to all films).
        units: Current units.
        max_cols: Maximum subplot columns.
        cmap: Colormap.
        colorbar: Add colorbars.
        shading: Tripcolor shading.
        auto_range_cutoff: IQR auto-range cutoff.
        share_color_scale: One color scale for all films.
        symmetric_color_scale: Symmetric limits about zero.
        vmin, vmax: Explicit color limits.

    Returns:
        ``(fig, axes)``.
    """
    units = units or solution.current_units

    def get_array(name):
        return (
            Quantity(solution.film_solutions[name].stream, solution.current_units)
            .to(units)
            .magnitude
        )

    return _plot_scalar_per_film(
        solution,
        films,
        get_array,
        f"$g$ [{units}]",
        "Stream function",
        max_cols,
        cmap,
        colorbar,
        shading,
        auto_range_cutoff,
        share_color_scale,
        symmetric_color_scale,
        vmin,
        vmax,
        **kwargs,
    )


def plot_fields(
    solution: Solution,
    films: Optional[Union[List[str], str]] = None,
    dataset: Literal[
        "field", "self_field", "applied_field", "field_from_other_films"
    ] = "field",
    normalize: bool = False,
    units: Optional[str] = None,
    shading: Literal["flat", "gouraud"] = "flat",
    max_cols: int = 3,
    cmap: str = "cividis",
    colorbar: bool = True,
    auto_range_cutoff: Optional[Union[float, Tuple[float, float]]] = None,
    share_color_scale: bool = False,
    symmetric_color_scale: bool = False,
    vmin: Optional[float] = None,
    vmax: Optional[float] = None,
    cross_section_coords: Optional[Union[np.ndarray, Sequence[np.ndarray]]] = None,
    **kwargs,
) -> Tuple["matplotlib.figure.Figure", np.ndarray]:
    """Plots a field dataset for each film.

    Args:
        solution: The solution to plot.
        films: Film name(s).
        dataset: "field", "self_field", "applied_field", or
            "field_from_other_films".
        normalize: Normalize by the applied field.
        units: Field units (ignored if ``normalize``).
        shading: Tripcolor shading.
        max_cols: Maximum subplot columns.
        cmap: Colormap.
        colorbar: Add colorbars.
        auto_range_cutoff: IQR auto-range cutoff.
        share_color_scale: One color scale for all films.
        symmetric_color_scale: Symmetric limits about zero.
        vmin, vmax: Explicit color limits.
        cross_section_coords: Path(s) for cross-section line cuts.

    Returns:
        ``(fig, axes)``.
    """
    from .solver.utils import convert_field

    units = units or solution.field_units

    dataset_attrs = {
        "field": "total_field",
        "self_field": "self_field",
        "applied_field": "applied_field",
        "field_from_other_films": "field_from_other_films",
    }
    if dataset not in dataset_attrs:
        raise ValueError(f"Invalid dataset: {dataset!r}.")

    def get_array(name):
        fs = solution.film_solutions[name]
        field = getattr(fs, dataset_attrs[dataset])
        if field is None:
            # Only field_from_other_films may be absent (single-film solve).
            field = np.zeros(len(solution.device.meshes[name].sites))
        if normalize:
            return field / fs.applied_field
        return convert_field(
            field,
            units,
            old_units=solution.field_units,
            ureg=solution.device.ureg,
            with_units=False,
        )

    label = "Normalized field" if normalize else f"$\\mu_0 H_z$ [{units}]"
    return _plot_scalar_per_film(
        solution,
        films,
        get_array,
        label,
        dataset.replace("_", " ").capitalize(),
        max_cols,
        cmap,
        colorbar,
        shading,
        auto_range_cutoff,
        share_color_scale,
        symmetric_color_scale,
        vmin,
        vmax,
        cross_section_coords=cross_section_coords,
        **kwargs,
    )


def plot_currents(
    solution: Solution,
    films: Optional[Union[List[str], str]] = None,
    units: Optional[str] = None,
    max_cols: int = 3,
    cmap: str = "inferno",
    colorbar: bool = True,
    shading: Literal["flat", "gouraud"] = "flat",
    auto_range_cutoff: Optional[Union[float, Tuple[float, float]]] = None,
    share_color_scale: bool = False,
    symmetric_color_scale: bool = False,
    vmin: Optional[float] = None,
    vmax: Optional[float] = None,
    streamplot: bool = True,
    grid_shape: Union[int, Tuple[int, int]] = (200, 200),
    min_stream_amp: float = 0.025,
    cross_section_coords: Optional[Union[np.ndarray, Sequence[np.ndarray]]] = None,
    **kwargs,
) -> Tuple["matplotlib.figure.Figure", np.ndarray]:
    """Plots the sheet current density magnitude with an optional
    streamplot overlay.

    Args:
        solution: The solution to plot.
        films: Film name(s).
        units: Current density units (default
            ``current_units / length_units``).
        max_cols: Maximum subplot columns.
        cmap: Colormap.
        colorbar: Add colorbars.
        shading: Tripcolor shading.
        auto_range_cutoff: IQR auto-range cutoff.
        share_color_scale: One color scale for all films.
        symmetric_color_scale: Symmetric limits about zero.
        vmin, vmax: Explicit color limits.
        streamplot: Overlay current streamlines.
        grid_shape: Interpolation grid for the streamplot.
        min_stream_amp: Hide streamlines where ``|J|`` is below this
            fraction of its maximum.
        cross_section_coords: Path(s) for cross-section line cuts.

    Returns:
        ``(fig, axes)``.
    """
    device = solution.device
    units = units or f"{solution.current_units} / {device.length_units}"
    if isinstance(films, str):
        films = [films]
    films = list(device.films) if films is None else list(films)
    grid_shape = (
        (grid_shape, grid_shape) if isinstance(grid_shape, int) else tuple(grid_shape)
    )

    def get_array(name):
        J = (
            Quantity(
                solution.film_solutions[name].current_density,
                f"{solution.current_units} / {device.length_units}",
            )
            .to(units)
            .magnitude
        )
        return np.linalg.norm(J, axis=1)

    fig, axes = _plot_scalar_per_film(
        solution,
        films,
        get_array,
        f"$|\\vec{{J}}|$ [{units}]",
        "Current density",
        max_cols,
        cmap,
        colorbar,
        shading,
        auto_range_cutoff,
        share_color_scale,
        symmetric_color_scale,
        vmin,
        vmax,
        cross_section_coords=cross_section_coords,
        **kwargs,
    )
    if streamplot:
        LinearTriInterpolator = require("matplotlib.tri").LinearTriInterpolator

        for ax, name in zip(np.atleast_1d(axes).flat, films):
            mesh = device.meshes[name]
            J = (
                Quantity(
                    solution.film_solutions[name].current_density,
                    f"{solution.current_units} / {device.length_units}",
                )
                .to(units)
                .magnitude
            )
            x, y = mesh.sites.T
            xgrid, ygrid = np.meshgrid(
                np.linspace(x.min(), x.max(), grid_shape[1]),
                np.linspace(y.min(), y.max(), grid_shape[0]),
            )
            Jx = LinearTriInterpolator(mesh.triangulation, J[:, 0])(xgrid, ygrid)
            Jy = LinearTriInterpolator(mesh.triangulation, J[:, 1])(xgrid, ygrid)
            Jx = np.ma.filled(Jx, 0)
            Jy = np.ma.filled(Jy, 0)
            amp = np.sqrt(Jx**2 + Jy**2)
            if min_stream_amp is not None and amp.max() > 0:
                mask = amp < min_stream_amp * amp.max()
                Jx[mask] = np.nan
                Jy[mask] = np.nan
            ax.streamplot(xgrid, ygrid, Jx, Jy, color="w", density=1, linewidth=0.75)
    return fig, axes


def plot_field_at_positions(
    solution: Solution,
    positions: np.ndarray,
    zs: Optional[Union[float, np.ndarray]] = None,
    units: Optional[str] = None,
    shading: Literal["flat", "gouraud"] = "gouraud",
    cmap: str = "cividis",
    colorbar: bool = True,
    auto_range_cutoff: Optional[Union[float, Tuple[float, float]]] = None,
    share_color_scale: bool = False,
    symmetric_color_scale: bool = False,
    vmin: Optional[float] = None,
    vmax: Optional[float] = None,
    cross_section_coords: Optional[Union[np.ndarray, Sequence[np.ndarray]]] = None,
    **kwargs,
) -> Tuple["matplotlib.figure.Figure", np.ndarray]:
    """Plots the total field at arbitrary positions in space (triangulating
    the given positions).

    Args:
        solution: The solution.
        positions: ``(m, 2)`` or ``(m, 3)`` evaluation coordinates.
        zs: z-coordinates if positions is ``(m, 2)``.
        units: Field units.
        shading: Tripcolor shading.
        cmap: Colormap.
        colorbar: Add a colorbar.
        auto_range_cutoff: IQR auto-range cutoff.
        share_color_scale: Shared color scale.
        symmetric_color_scale: Symmetric limits about zero.
        vmin, vmax: Explicit color limits.
        cross_section_coords: Path(s) for cross-section line cuts.

    Returns:
        ``(fig, axes)``.
    """
    device = solution.device
    units = units or solution.field_units
    positions = np.atleast_2d(positions)
    fields = solution.field_at_position(
        positions,
        zs=zs,
        units=units,
        with_units=False,
        return_sum=True,
    )
    num_plots = 1 + (1 if cross_section_coords is not None else 0)
    fig, axes = auto_grid(num_plots, max_cols=2, constrained_layout=True, **kwargs)
    axes_list = list(np.atleast_1d(axes).flat)
    ax = axes_list[0]
    clims = setup_color_limits(
        {"field": fields},
        vmin=vmin,
        vmax=vmax,
        share_color_scale=share_color_scale,
        symmetric_color_scale=symmetric_color_scale,
        auto_range_cutoff=auto_range_cutoff,
    )["field"]
    im = ax.tripcolor(
        positions[:, 0],
        positions[:, 1],
        fields,
        cmap=cmap,
        shading=shading,
        vmin=clims[0],
        vmax=clims[1],
    )
    ax.set_aspect("equal")
    ax.set_title("Total field")
    ax.set_xlabel(f"$x$ [{device.length_units}]")
    ax.set_ylabel(f"$y$ [{device.length_units}]")
    if colorbar:
        cbar = fig.colorbar(im, ax=ax)
        cbar.set_label(f"$\\mu_0 H_z$ [{units}]")
    if cross_section_coords is not None:
        xs_ax = axes_list[-1]
        coords, paths, sections = cross_section(
            positions[:, :2], fields, cross_section_coords
        )
        for i, (c, path, sect) in enumerate(zip(coords, paths, sections)):
            color = f"C{i % 10}"
            ax.plot(*c.T, "--", color=color, lw=2)
            xs_ax.plot(path, sect, color=color, lw=2)
        xs_ax.grid(True)
        xs_ax.set_xlabel(f"Distance along cut [{device.length_units}]")
        xs_ax.set_ylabel(f"$\\mu_0 H_z$ [{units}]")
    return fig, np.atleast_1d(axes)


def plot_mutual_inductance(
    M: Union[np.ndarray, List[np.ndarray]],
    diff: bool = False,
    iteration_offset: int = 0,
    absolute: bool = False,
    ax: Optional["matplotlib.axes.Axes"] = None,
    figsize: Optional[Tuple[float, float]] = None,
    logy: bool = False,
    grid: bool = True,
    legend: bool = True,
    **kwargs,
) -> Tuple["matplotlib.figure.Figure", "matplotlib.axes.Axes"]:
    """Plots the convergence vs. iteration of mutual-inductance matrices
    (the output of ``Device.mutual_inductance_matrix(all_iterations=True)``).

    Args:
        M: A list of ``(n, n)`` matrices (or a ``(m, n, n)`` array).
        diff: Plot the change between subsequent iterations.
        iteration_offset: First iteration to include.
        absolute: With ``diff``, plot absolute instead of relative change.
        ax: Axes to plot into.
        figsize: Figure size if creating a new figure.
        logy: Logarithmic y-axis.
        grid: Show grid lines.
        legend: Show a legend.

    Returns:
        ``(fig, ax)``.
    """
    plt = require("matplotlib.pyplot")
    mats = []
    units = None
    for item in np.atleast_1d(np.asarray(M, dtype=object)).tolist() if isinstance(M, list) else list(M):
        if isinstance(item, Quantity):
            units = units or str(item.units)
            item = item.magnitude
        mats.append(np.asarray(item))
    units = units or "pH"
    mats = np.stack(mats, axis=0)
    i0 = int(iteration_offset)
    if ax is None:
        fig, ax = plt.subplots(figsize=figsize)
    else:
        fig = ax.get_figure()
    iterations = np.arange(mats.shape[0])
    n = mats.shape[1]
    for i in range(n):
        for j in range(n):
            series = mats[:, i, j]
            if diff:
                d = np.abs(np.diff(series))
                if not absolute:
                    d = d / np.abs(series[1:])
                ax.plot(
                    iterations[i0 + 1 :],
                    d[i0:],
                    "o--",
                    label=f"$M_{{{i}{j}}}$",
                    **kwargs,
                )
            else:
                ax.plot(
                    iterations[i0:],
                    series[i0:],
                    "o--",
                    label=f"$M_{{{i}{j}}}$",
                    **kwargs,
                )
    if logy:
        ax.set_yscale("log")
    ax.set_xlabel("Iteration")
    if diff:
        if absolute:
            ax.set_ylabel(f"$|\\Delta M|$ [{units}]")
        else:
            ax.set_ylabel("$|\\Delta M| / |M|$")
    else:
        ax.set_ylabel(f"$M$ [{units}]")
    if grid:
        ax.grid(True)
    if legend:
        ax.legend(loc="best")
    return fig, ax


def plot_polygon_flux(
    solutions: List[Solution],
    diff: bool = False,
    iteration_offset: int = 0,
    absolute: bool = False,
    units: Optional[str] = None,
    ax: Optional["matplotlib.axes.Axes"] = None,
    figsize: Optional[Tuple[float, float]] = None,
    logy: bool = False,
    grid: bool = True,
    legend: bool = True,
    **kwargs,
) -> Tuple["matplotlib.figure.Figure", "matplotlib.axes.Axes"]:
    """Plots the convergence vs. iteration of the flux through all polygons
    (from the list of Solutions returned by :func:`superscreen_tpu_torch.solve`).

    Args:
        solutions: One Solution per iteration.
        diff: Plot the change between subsequent iterations.
        iteration_offset: First iteration to include.
        absolute: With ``diff``, plot absolute instead of relative change.
        units: Flux units.
        ax: Axes to plot into.
        figsize: Figure size if creating a new figure.
        logy: Logarithmic y-axis.
        grid: Show grid lines.
        legend: Show a legend.

    Returns:
        ``(fig, ax)``.
    """
    plt = require("matplotlib.pyplot")
    device = solutions[0].device
    units = units or f"{solutions[0].field_units} * {device.length_units}**2"
    polygons = [p.name for p in device.get_polygons(include_terminals=False)]
    flux = {name: [] for name in polygons}
    for solution in solutions:
        for name in polygons:
            flux[name].append(
                solution.polygon_flux(name, units=units, with_units=False)
            )
    if ax is None:
        fig, ax = plt.subplots(figsize=figsize)
    else:
        fig = ax.get_figure()
    i0 = int(iteration_offset)
    iterations = np.arange(len(solutions))
    for name, series in flux.items():
        series = np.asarray(series)
        if diff:
            d = np.abs(np.diff(series))
            if not absolute:
                d = d / np.abs(series[1:])
            ax.plot(iterations[i0 + 1 :], d[i0:], "o--", label=name, **kwargs)
        else:
            ax.plot(iterations[i0:], series[i0:], "o--", label=name, **kwargs)
    if logy:
        ax.set_yscale("log")
    ax.set_xlabel("Iteration")
    if diff:
        if absolute:
            ax.set_ylabel(f"$|\\Delta\\Phi|$ [{units}]")
        else:
            ax.set_ylabel("$|\\Delta\\Phi| / |\\Phi|$")
    else:
        ax.set_ylabel(f"$\\Phi$ [{units}]")
    if grid:
        ax.grid(True)
    if legend:
        ax.legend(loc="best")
    return fig, ax
