"""IBM SQUID susceptometer layouts (100 nm / 300 nm / 1 um / 3 um inner
pickup-loop radius).

Geometry digitized in the reference package
(``docs/notebooks/squids/ibm/{small,medium,large,xlarge}.py``); here all
four sizes share ONE spec-driven constructor: each size is a table of polygon
constructors plus terminal parameters, instead of four near-identical
modules.

Usage matches the reference::

    from superscreen_tpu_torch.squids import ibm
    device = ibm.small.make_squid(with_terminals=True)
"""

from functools import partial
from types import SimpleNamespace
from typing import Dict, Optional

import numpy as np

from ..device import Device, Polygon
from ..geometry import box, circle
from .layers import ibm_squid_layers

__all__ = ["make_squid", "small", "medium", "large", "xlarge"]


def _u(base_points, *extra_points):
    """Union of a base outline with one or more raw coordinate rings."""
    poly = Polygon(points=base_points)
    for pts in extra_points:
        poly = poly.union(np.asarray(pts, dtype=float))
    return poly.points


# ---------------------------------------------------------------------------
# Per-size geometry tables.  Every entry maps polygon name ->
# (layer, outline function); "terminal" holds the field-coil opening
# parameters (mask box, lead boxes, rotation, positions, fc resampling).
# Coordinates are in microns, digitized from the reference layouts.
# ---------------------------------------------------------------------------

def _small_spec():
    pl_length, ri_pl, ro_pl, ri_fc, ro_fc = 2.5, 0.1, 0.3, 0.5, 1.0125
    return dict(
        name="ibm_100nm",
        interp_points=201,
        films={
            "fc": (
                "BE",
                lambda: _u(
                    circle(ro_fc, center=(0, 0.01)),
                    [[2.30, -0.35], [2.00, -0.04], [1.19, 0.54], [0.60, 0.80],
                     [0.40, -0.9], [1.1, -1.30], [1.35, -1.9]],
                ),
            ),
            "fc_shield": (
                "W1",
                lambda: np.array(
                    [[2.5, -0.45], [2.15, -0.15], [2.00, -0.04], [1.31, 0.43],
                     [0.81, -0.08], [0.66, -1.23], [1.25, -2.65]]
                ),
            ),
            "pl_shield1": (
                "W2",
                lambda: np.array(
                    [[+0.35, -ri_pl], [-0.35, -ri_pl], [-0.98, -2.65],
                     [-1.05, -2.80], [+1.05, -2.80], [+0.98, -2.65]]
                ),
            ),
            "pl_shield2": (
                "BE",
                lambda: np.array(
                    [[+0.5, -1.5 - ri_pl], [-0.5, -1.5 - ri_pl],
                     [-0.84, -2.70], [+0.84, -2.70]]
                ),
            ),
            "pl": (
                "W1",
                lambda: _u(
                    box(2 * ro_pl, pl_length + ro_pl,
                        center=(0, -(pl_length + 0.3) / 2 + 3 * ri_pl)),
                    [[-0.30, -1.10], [-0.385, -1.7], [-0.64, -2.57],
                     [+0.62, -2.57], [+0.35, -1.67], [+0.30, -1.15]],
                ),
            ),
        },
        holes={
            "pl_center": (
                "W1",
                lambda: box(0.20, pl_length, center=(0, -pl_length / 2 + ri_pl)),
            ),
            "fc_center": (
                "BE",
                lambda: _u(
                    circle(ri_fc),
                    [[1.7, -0.47], [0.95, 0.02], [0.6, 0.11], [0.4, 0.28],
                     [0.33, -0.34], [0.69, -0.44], [1.4, -0.9]],
                ),
            ),
        },
        terminal=dict(
            angle=58, mask_size=(2.5, 0.75), mask_at=(1.7, -1),
            lead_size=(0.6, 0.05), source_at=(1.75, -0.2),
            drain_at=(1.21, -1.075), fc_points=501,
        ),
    )


def _medium_spec():
    pl_length, ri_pl, ro_pl, ri_fc, ro_fc = 2.2, 0.3, 0.5, 1.0, 1.5
    return dict(
        name="ibm_300nm",
        interp_points=201,
        films={
            "fc": (
                "BE",
                lambda: _u(
                    circle(ro_fc),
                    [[3.0, -1.05], [2.0, 0.0], [1.68, 0.2], [1.2, 0.52],
                     [0.85, -1.18], [1.12, -1.35], [1.55, -2.35]],
                ),
            ),
            "fc_shield": (
                "W1",
                lambda: np.array(
                    [[3.25, -1.25], [2.96, -0.9], [2.0, 0.0], [1.67, 0.19],
                     [1.11, -0.37], [0.9, -1.4], [1.5, -2.9]]
                ),
            ),
            "pl_shield1": (
                "W2",
                lambda: np.array(
                    [[+0.3, -0.4], [-0.3, -0.4], [-1.0, -2.7], [-1.2, -3.2],
                     [+1.2, -3.2], [+1.0, -2.7]]
                ),
            ),
            "pl_shield2": (
                "BE",
                lambda: np.array(
                    [[+0.75, -(2.3 - ri_pl)], [-0.75, -(2.3 - ri_pl)],
                     [-0.99, -3.0], [+0.96, -3.0]]
                ),
            ),
            "pl": (
                "W1",
                lambda: _u(
                    circle(ro_pl),
                    [[+0.3, -0.4], [-0.3, -0.4], [-0.87, -2.8], [+0.85, -2.8]],
                ),
            ),
        },
        holes={
            "pl_center": (
                "W1",
                lambda: _u(
                    circle(ri_pl),
                    box(0.2, pl_length,
                        center=(0, -pl_length / 2 - 0.9 * ri_pl)),
                ),
            ),
            "fc_center": (
                "BE",
                lambda: _u(
                    circle(ri_fc),
                    [[2.2, -1.2], [1.7, -0.45], [0.97, 0.0], [0.8, -0.5],
                     [1.23, -0.78], [1.4, -0.9], [1.85, -1.55]],
                ),
            ),
        },
        terminal=dict(
            angle=43, mask_size=(2.5, 0.75), mask_at=(2.25, -1.6),
            lead_size=(0.75, 0.05), source_at=(2.4, -0.95),
            drain_at=(1.6, -1.7), fc_points=501,
        ),
    )


def _large_spec():
    pl_length, ri_pl, ro_pl, ri_fc, ro_fc = 4.0, 1.0, 1.5, 2.5, 3.5
    return dict(
        name="ibm_1000nm",
        interp_points=301,
        films={
            "fc": (
                "BE",
                lambda: _u(
                    circle(ro_fc),
                    [[5.8, -3.9], [2.8, -0.9], [1.5, -2.3], [3.2, -6.0]],
                ),
            ),
            "fc_shield": (
                "W1",
                lambda: np.array(
                    [[6.4, -4.05], [3.45, -1.4], [1.65, -3.3], [3.1, -6.8]]
                ),
            ),
            "pl_shield1": (
                "W2",
                lambda: np.array(
                    [[+1.0, -2.8], [+0.6, -(ri_pl + 0.4)], [-0.6, -(ri_pl + 0.4)],
                     [-1.0, -2.8], [-2.6, -6.4], [-2.75, -6.9], [+2.75, -6.9],
                     [+2.6, -6.4]]
                ),
            ),
            "pl_shield2": (
                "BE",
                lambda: np.array(
                    [[+1.25, -(2.55 + ro_pl)], [-1.25, -(2.55 + ro_pl)],
                     [-2.0, -6.2], [+2.0, -6.2]]
                ),
            ),
            "pl": (
                "W1",
                lambda: _u(
                    circle(ro_pl),
                    [[1.5, -5.7], [0.41, -1], [-0.41, -1], [-1.5, -5.7]],
                ),
            ),
        },
        holes={
            "pl_center": (
                "W1",
                lambda: _u(
                    circle(ri_pl),
                    box(0.2, pl_length,
                        center=(0, -pl_length / 2 - 0.9 * ri_pl)),
                ),
            ),
            "fc_center": (
                "BE",
                lambda: _u(
                    circle(ri_fc),
                    [[4.3, -4.2], [2.1, -1.0], [1.8, -1.6], [3.85, -4.55]],
                ),
            ),
        },
        terminal=dict(
            angle=40, mask_size=(4, 1), mask_at=(4.25, -4.75),
            lead_size=(1.5, 0.1), source_at=(4.7, -3.7),
            drain_at=(3.3, -4.9), fc_points=1001,
        ),
    )


def _xlarge_spec():
    pl_length, ri_pl, ro_pl, ri_fc, ro_fc = 11.5, 3.0, 3.5, 6.0, 8.8
    return dict(
        name="ibm_3000nm",
        interp_points=301,
        films={
            "fc": (
                "BE",
                lambda: _u(
                    circle(ro_fc),
                    [[12.0, -9.6], [7.5, -4.8], [4.2, -4.2], [3.2, -7.8],
                     [6.0, -13.5]],
                ),
            ),
            "fc_shield": (
                "W1",
                lambda: np.array(
                    [[13.3, -10.2], [7.7, -4.8], [3.3, -8.1], [6.1, -15.0]]
                ),
            ),
            "pl_shield1": (
                "W2",
                lambda: np.array(
                    [[+2.6, -6.3], [+1.3, -3.6], [-1.3, -3.6], [-2.6, -6.3],
                     [-6.0, -16.0], [+6.0, -16.0]]
                ),
            ),
            "pl_shield2": (
                "BE",
                lambda: np.array(
                    [[+4.5, -13.2], [-4.5, -13.2], [-5.3, -15.5], [+5.3, -15.5]]
                ),
            ),
            "pl": (
                "W1",
                lambda: _u(
                    circle(ro_pl),
                    [[+0.8, -2.7], [-0.8, -2.7], [-4.6, -15.0], [+4.6, -15.0]],
                ),
            ),
        },
        holes={
            "pl_center": (
                "W1",
                lambda: _u(
                    circle(ri_pl),
                    box(0.314, pl_length,
                        center=(0, -pl_length / 2 - 0.9 * ri_pl)),
                ),
            ),
            "fc_center": (
                "BE",
                lambda: _u(
                    circle(ri_fc),
                    [[8.5, -10.3], [4.15, -4.15], [3.55, -4.75], [7.75, -10.75]],
                ),
            ),
        },
        terminal=dict(
            angle=33, mask_size=(8, 2), mask_at=(8.5, -11),
            lead_size=(3.5, 0.2), source_at=(9.5, -9.1),
            drain_at=(6.25, -11.25), fc_points=1001,
        ),
        layer_overrides=dict(d_I1=0.4, d_I2=0.4),
    )


_SPECS = {
    "small": _small_spec,
    "medium": _medium_spec,
    "large": _large_spec,
    "xlarge": _xlarge_spec,
}


def _open_field_coil(fc: Polygon, fc_center: Polygon, term: Dict) -> tuple:
    """Cut the field coil open and attach source/drain terminals."""
    mask = (
        Polygon(points=box(*term["mask_size"]))
        .rotate(term["angle"])
        .translate(*term["mask_at"])
    )
    fc = fc.difference(mask, fc_center).resample(term["fc_points"])

    def lead(name, at):
        return (
            Polygon(name, layer="BE", points=box(*term["lead_size"]))
            .rotate(term["angle"])
            .translate(*at)
        )

    terminals = {
        "fc": [lead("source", term["source_at"]), lead("drain", term["drain_at"])]
    }
    return fc, terminals


def make_squid(
    size: str,
    with_terminals: bool = True,
    align_layers: str = "middle",
    length_units: str = "um",
    layer_kwargs: Optional[Dict] = None,
) -> Device:
    """Builds an IBM susceptometer Device.

    Args:
        size: "small" (100 nm), "medium" (300 nm), "large" (1 um), or
            "xlarge" (3 um inner pickup-loop radius).
        with_terminals: Cut the field coil open and attach source/drain
            transport terminals (as in the reference layouts).
        align_layers: Model-plane placement within each metal layer.
        length_units: Device length units.
        layer_kwargs: Extra arguments for :func:`ibm_squid_layers`.
    """
    if size not in _SPECS:
        raise ValueError(
            f"Unknown IBM SQUID size {size!r}; expected one of {sorted(_SPECS)}."
        )
    spec = _SPECS[size]()
    n_interp = spec["interp_points"]

    def build(table):
        return {
            name: Polygon(name, layer=layer, points=make()).resample(n_interp)
            for name, (layer, make) in table.items()
        }

    films = build(spec["films"])
    holes = build(spec["holes"])

    terminals = None
    if with_terminals:
        films["fc"], terminals = _open_field_coil(
            films["fc"], holes.pop("fc_center"), spec["terminal"]
        )

    kwargs = dict(spec.get("layer_overrides", {}))
    kwargs.update(layer_kwargs or {})
    return Device(
        spec["name"],
        layers=ibm_squid_layers(align=align_layers, **kwargs),
        films=list(films.values()),
        holes=list(holes.values()),
        terminals=terminals,
        length_units=length_units,
    )


# Reference-compatible access: ibm.small.make_squid(...), etc.
small = SimpleNamespace(make_squid=partial(make_squid, "small"))
medium = SimpleNamespace(make_squid=partial(make_squid, "medium"))
large = SimpleNamespace(make_squid=partial(make_squid, "large"))
xlarge = SimpleNamespace(make_squid=partial(make_squid, "xlarge"))
