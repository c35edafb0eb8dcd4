"""Parametric scanning-SQUID susceptometer device generator.

The reference ships hand-digitized layouts of real SQUID susceptometers
(Huber, IBM, Hypres families; ``docs/notebooks/squids/``) used as
validation and benchmark workloads.  This module provides the same
capability as a single *parametric* generator: a susceptometer is a
pickup loop (with center hole and shield) in one wiring layer plus a
concentric field coil (with transport terminals or a closed hole) in
another layer, each built from a C-shaped washer with lead rails.  Size
presets spanning the same scale range as the reference layouts are
provided; all coordinates are generated, not digitized.
"""

from dataclasses import dataclass, replace
from typing import Dict, Optional

import numpy as np

from ..device import Device, Layer, Polygon
from ..geometry import box, rotate

__all__ = [
    "loop_with_leads",
    "SusceptometerGeometry",
    "SQUID_PRESETS",
    "make_squid",
    "squid_mutual_inductance",
]


def loop_with_leads(
    radius: float,
    lead_width: float,
    lead_length: float,
    angle: float = 0.0,
    arc_points: int = 101,
) -> np.ndarray:
    """A C-shaped contour: a circular arc of the given ``radius`` opened at
    the bottom by ``lead_width``, extended by two straight lead rails of the
    given length, closed across the lead ends.

    Args:
        radius: Arc radius.
        lead_width: Width of the gap (and separation of the lead rails).
        lead_length: Length of the lead rails below the arc.
        angle: Rotation of the whole contour (degrees, CCW; the gap points
            down for ``angle = 0``).
        arc_points: Number of points along the arc.

    Returns:
        A closed ``(m, 2)`` coordinate array.
    """
    x0 = lead_width / 2
    theta0 = np.arcsin(min(x0 / radius, 1.0))
    thetas = (
        np.linspace(theta0, 2 * np.pi - theta0, arc_points) - np.pi / 2
    )
    arc = radius * np.stack([np.cos(thetas), np.sin(thetas)], axis=1)
    y_leads = -(radius * np.cos(theta0) + lead_length)
    points = np.concatenate(
        [
            [[-x0, y_leads]],
            arc[::-1],
            [[x0, y_leads]],
            [[-x0, y_leads]],
        ]
    )
    if angle:
        points = rotate(points, angle)
    return points


@dataclass
class SusceptometerGeometry:
    """Parameters defining a two-coil susceptometer.

    All lengths are in the device's ``length_units`` (microns by default).

    Args:
        ri_pl, ro_pl: Inner/outer radii of the pickup loop.
        w_pl_center, w_pl_outer: Center-conductor and outer widths of the
            pickup-loop leads.
        pl_lead_length: Length of the pickup-loop leads.
        ri_fc, ro_fc: Inner/outer radii of the field coil.
        w_fc_center, w_fc_outer: Center-conductor and outer widths of the
            field-coil leads.
        fc_lead_length: Length of the field-coil leads.
        fc_angle: Rotation of the field coil relative to the pickup loop.
        d_be, d_w1, d_w2: Layer thicknesses (field coil in BE, pickup loop
            in W1, shield in W2).
        i1_gap, i2_gap: Insulator gaps between layers.
        london_lambda: London penetration depth of all layers.
    """

    ri_pl: float = 1.7
    ro_pl: float = 2.7
    w_pl_center: float = 1.2
    w_pl_outer: float = 3.1
    pl_lead_length: float = 10.0
    ri_fc: float = 5.5
    ro_fc: float = 8.0
    w_fc_center: float = 1.6
    w_fc_outer: float = 7.0
    fc_lead_length: float = 5.0
    fc_angle: float = 45.0
    d_be: float = 0.2
    d_w1: float = 0.23
    d_w2: float = 0.25
    i1_gap: float = 0.35
    i2_gap: float = 0.35
    london_lambda: float = 0.08

    def scaled(self, factor: float) -> "SusceptometerGeometry":
        """All lateral dimensions scaled by ``factor`` (layer stack
        unchanged)."""
        return replace(
            self,
            ri_pl=self.ri_pl * factor,
            ro_pl=self.ro_pl * factor,
            w_pl_center=self.w_pl_center * factor,
            w_pl_outer=self.w_pl_outer * factor,
            pl_lead_length=self.pl_lead_length * factor,
            ri_fc=self.ri_fc * factor,
            ro_fc=self.ro_fc * factor,
            w_fc_center=self.w_fc_center * factor,
            w_fc_outer=self.w_fc_outer * factor,
            fc_lead_length=self.fc_lead_length * factor,
        )


#: Size presets spanning the same scale range as the reference layouts
#: (pickup-loop radii from ~0.5 to ~10 um).
SQUID_PRESETS: Dict[str, SusceptometerGeometry] = {
    "small": SusceptometerGeometry().scaled(0.3),
    "medium": SusceptometerGeometry().scaled(0.6),
    "large": SusceptometerGeometry(),
    "xlarge": SusceptometerGeometry().scaled(3.0),
}


def make_squid(
    geometry: "SusceptometerGeometry | str" = "large",
    with_terminals: bool = True,
    length_units: str = "um",
    align: str = "bottom",
    name: Optional[str] = None,
) -> Device:
    """Builds a scanning-SQUID susceptometer :class:`Device`.

    The device has three layers (W2 shield at the bottom, W1 pickup loop,
    BE field coil on top).  The pickup loop is a washer whose center hole
    ``"pl_center"`` defines the flux-sensing area; the field coil either
    carries transport current through ``source``/``drain`` terminals
    (``with_terminals=True``) or is a closed loop with hole
    ``"fc_center"``.

    Args:
        geometry: A :class:`SusceptometerGeometry` or a preset name from
            :data:`SQUID_PRESETS`.
        with_terminals: Model the field coil with transport terminals.
        length_units: Device length units.
        align: ``"bottom"`` stacks layers upward from z = 0.
        name: Device name.

    Returns:
        The susceptometer :class:`Device` (unmeshed).
    """
    if isinstance(geometry, str):
        if geometry not in SQUID_PRESETS:
            raise ValueError(
                f"Unknown preset {geometry!r}; available: "
                f"{sorted(SQUID_PRESETS)}."
            )
        name = name or f"squid_{geometry}"
        geometry = SQUID_PRESETS[geometry]
    g = geometry
    name = name or "squid"

    # Layer stack (bottom to top): W2, W1, BE.
    z0_w2 = 0.0
    z0_w1 = z0_w2 + g.d_w2 + g.i2_gap
    z0_be = z0_w1 + g.d_w1 + g.i1_gap
    if align != "bottom":
        raise ValueError(f"Unknown align: {align!r}.")
    lam = g.london_lambda
    layers = [
        Layer("W2", london_lambda=lam, thickness=g.d_w2, z0=z0_w2),
        Layer("W1", london_lambda=lam, thickness=g.d_w1, z0=z0_w1),
        Layer("BE", london_lambda=lam, thickness=g.d_be, z0=z0_be),
    ]

    # Pickup loop: washer film with center hole, gap pointing down.
    pl = Polygon(
        "pl",
        layer="W1",
        points=loop_with_leads(g.ro_pl, g.w_pl_outer, g.pl_lead_length - g.ro_pl),
    )
    pl_center = Polygon(
        "pl_center",
        layer="W1",
        points=loop_with_leads(
            g.ri_pl, g.w_pl_center, (g.ro_pl - g.ri_pl), arc_points=81
        ),
    )
    # Shield under the pickup-loop leads (W2).
    shield_w = g.w_pl_outer + 0.5 * (g.ro_pl - g.ri_pl)
    shield_len = g.pl_lead_length - g.ri_pl
    pl_shield = Polygon(
        "pl_shield",
        layer="W2",
        points=box(
            shield_w,
            shield_len,
            points=41,
            center=(0, -(g.ri_pl + 0.25 * (g.ro_pl - g.ri_pl) + shield_len / 2)),
        ),
    )

    # Field coil: C-shaped washer, optionally with terminals.
    fc_outer = loop_with_leads(
        g.ro_fc, g.w_fc_outer, g.fc_lead_length, angle=g.fc_angle
    )
    # Arc bottoms: the outer contour reaches y = -(ro cos(t_o) + lead).
    cos_to = np.cos(np.arcsin(min(g.w_fc_outer / 2 / g.ro_fc, 1.0)))
    cos_tc = np.cos(np.arcsin(min(g.w_fc_center / 2 / g.ri_fc, 1.0)))
    y_outer_bottom = -(g.ro_fc * cos_to + g.fc_lead_length)
    if with_terminals:
        # The center slit pokes through the film bottom so the coil is an
        # open "C" whose two rails carry the transport current.
        y_center_bottom = y_outer_bottom - 0.1 * g.ro_fc
    else:
        # The center hole stays strictly inside the film so the coil is a
        # closed loop around the hole "fc_center".
        y_center_bottom = y_outer_bottom + 0.5 * (g.ro_fc - g.ri_fc)
    fc_center_lead = -y_center_bottom - g.ri_fc * cos_tc
    fc_center_pts = loop_with_leads(
        g.ri_fc, g.w_fc_center, fc_center_lead, angle=g.fc_angle
    )
    fc = Polygon("fc", layer="BE", points=fc_outer)
    holes = [pl_center]
    terminals = None
    if with_terminals:
        # The center slit opens the coil into two rails; terminals straddle
        # the rail ends at the film bottom.
        fc = fc.difference(fc_center_pts).resample(401)
        fc.name = "fc"
        fc.layer = "BE"
        rail_w = (g.w_fc_outer - g.w_fc_center) / 2
        term_len = 0.08 * g.ro_fc
        x_rail = (g.w_fc_center + rail_w) / 2
        source = Polygon(
            "source",
            layer="BE",
            points=rotate(
                box(rail_w * 1.5, term_len, points=17)
                + np.array([[-x_rail, y_outer_bottom]]),
                g.fc_angle,
            ),
        )
        drain = Polygon(
            "drain",
            layer="BE",
            points=rotate(
                box(rail_w * 1.5, term_len, points=17)
                + np.array([[+x_rail, y_outer_bottom]]),
                g.fc_angle,
            ),
        )
        terminals = {"fc": [source, drain]}
    else:
        holes.append(Polygon("fc_center", layer="BE", points=fc_center_pts))

    device = Device(
        name,
        layers=layers,
        films=[fc, pl, pl_shield],
        holes=holes,
        terminals=terminals,
        length_units=length_units,
    )
    return device


def squid_mutual_inductance(
    device: Device,
    iterations: int = 5,
    current: str = "1 mA",
    units: str = "Phi_0 / A",
    **solve_kwargs,
):
    """Mutual inductance between the field coil and the pickup loop.

    For terminal devices, drives ``current`` through the field coil
    terminals and evaluates the pickup-loop center fluxoid; for closed
    field coils, circulates ``current`` around ``fc_center``.

    Args:
        device: A susceptometer from :func:`make_squid` (meshed).
        iterations: Self-consistent coupling rounds.
        current: The field-coil current.
        units: Units for the mutual inductance.
        solve_kwargs: Passed to :func:`superscreen_tpu_torch.solve`
            (``torch_device``, ``high_precision``, ...).

    Returns:
        The mutual inductance as a Quantity.
    """
    from ..solver import solve
    from ..units import ureg

    I_fc = ureg(current)
    if device.terminals:
        solution = solve(
            device,
            terminal_currents={
                "fc": {"source": current, "drain": f"-{current}"}
            },
            iterations=iterations,
            progress_bar=False,
            **solve_kwargs,
        )[-1]
    else:
        solution = solve(
            device,
            circulating_currents={"fc_center": current},
            iterations=iterations,
            progress_bar=False,
            **solve_kwargs,
        )[-1]
    M = sum(solution.hole_fluxoid("pl_center")) / I_fc
    return M.to(units)
