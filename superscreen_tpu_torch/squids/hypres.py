"""Hypres SQUID susceptometer layouts (400 nm and 250 nm).

The reference builds these from digitized GDS coordinate files
(``docs/notebooks/squids/hypres/small.py:11-20`` loads
``hypres-400nm.npz``; ``xsmall.py:22`` loads ``hypres-250nm.npz``).
The same digitized coordinates are bundled here under ``squids/data/``,
so both layouts work out of the box; an explicit ``data_path`` (or the
``SUPERSCREEN_TPU_HYPRES_DATA`` directory) overrides the bundled files.
"""

import os
from typing import Dict, Optional

import numpy as np

from ..device import Device, Polygon
from ..geometry import box, close_curve
from .layers import hypres_squid_layers

__all__ = [
    "hypres_squid_layers",
    "load_polygons",
    "make_squid",
    "make_squid_xsmall",
]

_LAYER_OF = {
    "fc": "BE",
    "fc_center": "BE",
    "fc_shield": "W1",
    "pl": "W1",
    "pl_center": "W1",
    "pl_shield": "W2",
    "pl_shield2": "BE",
}


def _data_path(filename: str, data_path: Optional[str]) -> str:
    if data_path is not None:
        return data_path
    root = os.environ.get("SUPERSCREEN_TPU_HYPRES_DATA")
    if root:
        candidate = os.path.join(root, filename)
        if os.path.isfile(candidate):
            return candidate
    bundled = os.path.join(os.path.dirname(__file__), "data", filename)
    if os.path.isfile(bundled):
        return bundled
    raise FileNotFoundError(
        f"The digitized Hypres geometry file {filename!r} was not found "
        "in the bundled squids/data directory. Provide it via the "
        "data_path argument or the SUPERSCREEN_TPU_HYPRES_DATA directory."
    )


def load_polygons(
    filename: str = "hypres-400nm.npz", data_path: Optional[str] = None
) -> Dict[str, np.ndarray]:
    """Loads the digitized polygon coordinates for a Hypres layout."""
    with np.load(_data_path(filename, data_path)) as data:
        return dict(data)


def make_polygons(data_path: Optional[str] = None):
    """Returns ``(films, holes)`` dicts of raw (un-resampled) Polygons for the
    400 nm layout — API parity with the reference
    ``docs/notebooks/squids/hypres/small.py:11-20``."""
    coords = load_polygons("hypres-400nm.npz", data_path)
    films = {
        name: Polygon(name, points=coords[name])
        for name in ("fc", "fc_shield", "pl", "pl_shield")
    }
    holes = {
        name: Polygon(name, points=coords[name])
        for name in ("pl_center", "fc_center")
    }
    return films, holes


def make_squid(
    with_terminals: bool = True,
    align_layers: str = "middle",
    data_path: Optional[str] = None,
) -> Device:
    """Builds the Hypres 400 nm susceptometer (reference
    ``docs/notebooks/squids/hypres/small.py``) from digitized coordinates.

    Args:
        with_terminals: Cut the field coil open and attach source/drain
            terminals.
        align_layers: Model-plane placement within each metal layer.
        data_path: Path to ``hypres-400nm.npz`` (see module docstring).
    """
    coords = load_polygons("hypres-400nm.npz", data_path)
    films = {
        name: Polygon(name, layer=_LAYER_OF[name], points=coords[name]).resample(151)
        for name in ("fc", "fc_shield", "pl", "pl_shield")
    }
    holes = {
        name: Polygon(name, layer=_LAYER_OF[name], points=coords[name]).resample(151)
        for name in ("pl_center", "fc_center")
    }

    terminals = None
    if with_terminals:
        fc_center = holes.pop("fc_center")
        mask = Polygon(points=box(5)).rotate(45).translate(6.5, -5.5)
        films["fc"] = (
            films["fc"].difference(mask, fc_center).resample(501).set_layer("BE")
        )

        def lead(name, dx, dy):
            return (
                Polygon(name, layer="BE", points=box(2, 0.1))
                .rotate(45)
                .translate(dx, dy)
            )

        terminals = {"fc": [lead("source", 5.5, -2.95), lead("drain", 3.95, -4.5)]}

    return Device(
        "hypres_400nm",
        layers=hypres_squid_layers(align=align_layers),
        films=list(films.values()),
        holes=list(holes.values()),
        terminals=terminals,
        length_units="um",
    )


#: Raw-vertex span of the field coil's inner winding in ``hypres-250nm.npz``
#: (``coords["fc"][2:23]``): the contiguous arc that loops once around the
#: origin between the two lead crossings.  The bundled data is immutable, so
#: identifying the turn by digitized-vertex range is deterministic.
_XSMALL_INNER_TURN = slice(2, 23)

#: Points bridging the lead gap when the inner winding is closed into the
#: ``fc_center`` hole (reference ``hypres/xsmall.py:48-50``).
_XSMALL_BRIDGE_NEAR = (3.9, -3.92)
_XSMALL_BRIDGE_FAR = (4.55, -3.5)


def _drop_matching(points: np.ndarray, bank: np.ndarray) -> np.ndarray:
    """Removes from a closed curve every vertex that appears in ``bank``."""
    open_pts = points[:-1] if np.allclose(points[0], points[-1]) else points
    d2 = ((open_pts[:, None, :] - bank[None, :, :]) ** 2).sum(-1)
    return close_curve(open_pts[d2.min(axis=1) > 1e-16])


def make_squid_xsmall(
    with_terminals: bool = True,
    align_layers: str = "middle",
    data_path: Optional[str] = None,
) -> Device:
    """Builds the Hypres 250 nm ("xsmall") susceptometer (reference
    ``docs/notebooks/squids/hypres/xsmall.py``).

    The digitized field coil is a two-turn spiral; clipping it against a
    rotated box yields the device outline, and the inner winding either
    stays part of the coil film (transport layout) or is closed across the
    lead gap into the ``fc_center`` hole (closed layout).

    Args:
        with_terminals: Keep the field coil open with source/drain
            terminals; otherwise close it and model the circulating
            current via the ``fc_center`` hole.
        align_layers: Model-plane placement within each metal layer.
        data_path: Path to ``hypres-250nm.npz`` (defaults to the bundled
            copy).
    """
    coords = load_polygons("hypres-250nm.npz", data_path)
    inner_turn = coords["fc"][_XSMALL_INNER_TURN]

    fc_outline = (
        Polygon(points=coords["fc"])
        .intersection(Polygon(points=box(12)).rotate(30))
        .points
    )
    shield_outline = (
        Polygon(points=coords["fc_shield"])
        .intersection(Polygon(points=box(15)).rotate(30))
        .points
    )
    pl_pts = coords["pl"][np.abs(coords["pl"][:, 1]) > 0.05]

    film_pts = {
        "fc_shield": shield_outline,
        "pl": pl_pts,
        "pl_shield": coords["pl_shield"],
        "pl_shield2": coords["pl_shield2"],
    }
    hole_pts = {
        "pl_center": np.array(
            [[0.2, -4.75], [0.2, 0.01], [-0.3, 0.01], [-0.3, -4.75]]
        ),
    }
    # The inner winding always leaves the film boundary, so the lead gap
    # is spanned by a straight edge and the coil opening falls inside the
    # film outline.  With terminals that opening stays conducting film
    # (transport layout); without, it is carved back out as the
    # ``fc_center`` hole built from the winding arc plus two bridge
    # points across the gap.
    film_pts["fc"] = _drop_matching(fc_outline, inner_turn)
    if not with_terminals:
        hole_pts["fc_center"] = np.concatenate(
            [[_XSMALL_BRIDGE_NEAR], inner_turn[::-1], [_XSMALL_BRIDGE_FAR]]
        )

    films, holes = {}, {}
    for group, source in ((films, film_pts), (holes, hole_pts)):
        for name, pts in source.items():
            n = 401 if (with_terminals and name == "fc") else 201
            group[name] = Polygon(
                name, layer=_LAYER_OF[name], points=pts
            ).resample(n)

    terminals = None
    if with_terminals:

        def lead(name, dx, dy):
            return (
                Polygon(name, layer="BE", points=box(2, 0.1))
                .rotate(30)
                .translate(dx, dy)
            )

        terminals = {"fc": [lead("source", 5.7, -3.66), lead("drain", 3.75, -4.75)]}

    return Device(
        "hypres_250nm",
        layers=hypres_squid_layers(align=align_layers),
        films=list(films.values()),
        holes=list(holes.values()),
        terminals=terminals,
        length_units="um",
    )
