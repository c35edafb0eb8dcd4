"""Huber-design SQUID susceptometer layout.

Geometry digitized in the reference package
(``docs/notebooks/squids/huber.py``; dimensions from N. Koshnick's thesis,
p. 29 and Table 3.2).  The pickup loop and field coil are both "broken
rings": a circular arc whose opening is bridged by straight leads running
to a fixed baseline -- built here by one shared :func:`_broken_ring`
helper instead of four hand-unrolled point lists.
"""

from typing import Dict, Optional

import numpy as np

from ..device import Device, Polygon
from ..geometry import box, rotate
from .layers import _trilayer

__all__ = ["huber_geometry", "make_squid"]


def _arc(radius: float, half_gap_x: float, n: int = 101) -> np.ndarray:
    """CCW circular arc of ``radius`` whose endpoints sit at
    ``x = +/- half_gap_x`` below the center (the ring opening faces -y)."""
    theta0 = np.arcsin(half_gap_x / radius)
    thetas = np.linspace(theta0, 2 * np.pi - theta0, n) - np.pi / 2
    return radius * np.stack([np.cos(thetas), np.sin(thetas)], axis=1)


def _broken_ring(
    radius: float,
    gap_width: float,
    baseline_y: float,
    degrees: float = 0.0,
    reverse_arc: bool = True,
) -> np.ndarray:
    """A ring opened at the bottom with straight leads down to
    ``y = baseline_y``, closed along the baseline."""
    arc = _arc(radius, gap_width / 2)
    if reverse_arc:
        arc = arc[::-1]
    # The leads drop straight down from the arc endpoints to the baseline;
    # the ring closes along the baseline.
    points = np.concatenate(
        [
            [[arc[0, 0], baseline_y]],
            arc,
            [[arc[-1, 0], baseline_y]],
            [[arc[0, 0], baseline_y]],
        ]
    )
    return rotate(points, degrees)


def huber_geometry(interp_points: Optional[int] = 101) -> Dict[str, np.ndarray]:
    """The six Huber-SQUID polygons (microns), optionally resampled."""
    # Pickup loop (vertical, angle 0).
    ri_pl, ro_pl = 1.7, 2.7
    w_pl_center, w_pl_outer = 1.18, 3.10
    y_pl_base = -(15 - ro_pl)  # total pickup-loop length 15 um
    pl = _broken_ring(ro_pl, w_pl_outer, y_pl_base)
    pl_center = _broken_ring(
        ri_pl, w_pl_center, y_pl_base + (ro_pl - ri_pl), reverse_arc=False
    )
    half_w = w_pl_outer / 2 + 0.25
    pl_shield = np.array(
        [
            [-half_w, -(ri_pl + 0.5)],
            [-w_pl_outer / 2, -(ri_pl + 0.25)],
            [+w_pl_outer / 2, -(ri_pl + 0.25)],
            [+half_w, -(ri_pl + 0.5)],
            [+half_w, y_pl_base - 0.5],
            [-half_w, y_pl_base - 0.5],
            [-half_w, -(ri_pl + 0.5)],
        ]
    )

    # Field coil (rotated 45 degrees).
    ri_fc, ro_fc = 5.5, 8.0
    w_fc_center, w_fc_outer = 1.6, 7.0
    fc_angle = 45.0
    fc_center = _broken_ring(ri_fc, w_fc_center, -(6 + ri_fc), degrees=fc_angle)
    fc = _broken_ring(ro_fc, w_fc_outer, -(6 + ro_fc), degrees=fc_angle)
    w_sh, w0_sh = 10.0, 2.0
    y_base_sh = -(6 + ro_fc) - 1
    fc_shield = rotate(
        np.array(
            [
                [-w_sh / 2, y_base_sh],
                [-w_sh / 2, -(ro_fc + 1)],
                [-w0_sh / 2, -(ri_fc - 0.5)],
                [+w0_sh / 2, -(ri_fc - 0.5)],
                [+w_sh / 2, -(ro_fc + 1)],
                [+w_sh / 2, y_base_sh],
                [-w_sh / 2, y_base_sh],
            ]
        ),
        fc_angle,
    )

    polygons = {
        "pl": pl,
        "pl_shield": pl_shield,
        "pl_center": pl_center,
        "fc": fc,
        "fc_center": fc_center,
        "fc_shield": fc_shield,
    }
    if interp_points is not None:
        polygons = {
            name: Polygon(points=pts).resample(interp_points).points
            for name, pts in polygons.items()
        }
    return polygons


def make_squid(with_terminals: bool = True) -> Device:
    """Builds the Huber susceptometer Device (reference
    ``docs/notebooks/squids/huber.py:164-227``)."""
    polygons = huber_geometry(interp_points=151)

    # Koshnick thesis stack, model planes at the metal-layer bottoms.
    layers = _trilayer(
        "bottom", london_lambda=0.08, z0=0.0,
        d_BE=0.2, d_I1=0.350, d_W1=0.23, d_I2=0.350, d_W2=0.25,
    )

    films = {
        "fc_shield": Polygon("fc_shield", layer="W1", points=polygons["fc_shield"]),
        "pl": Polygon("pl", layer="W1", points=polygons["pl"]),
        "pl_shield": Polygon("pl_shield", layer="W2", points=polygons["pl_shield"]),
    }
    fc = Polygon("fc", layer="BE", points=polygons["fc"])
    fc_center = Polygon("fc_center", layer="BE", points=polygons["fc_center"])
    holes = [Polygon("pl_center", layer="W1", points=polygons["pl_center"])]

    terminals = None
    if with_terminals:
        mask = Polygon(points=box(10, 3)).rotate(45).translate(9, -9)
        fc = fc.difference(mask, fc_center).resample(1001)

        def lead(name, dx, dy):
            return (
                Polygon(name, layer="BE", points=box(3, 0.1))
                .rotate(45)
                .translate(dx, dy)
            )

        terminals = {"fc": [lead("source", 9.45, -6.45), lead("drain", 6.45, -9.45)]}
    else:
        holes.append(fc_center)

    return Device(
        "huber_squid",
        layers=layers,
        films=[fc] + list(films.values()),
        holes=holes,
        terminals=terminals,
        length_units="um",
    )
