"""Pickup-loop / field-coil mutual inductance validation workload.

The reference ships this as a CLI-ish script
(``docs/notebooks/squids/mutuals.py:1-74``); here it is a callable API so
tests and benchmarks can run any subset of the real layouts.

For terminal layouts the mutual is the pickup-loop fluxoid per unit
transport current through the field coil; for closed layouts it is the
off-diagonal entry of :meth:`Device.mutual_inductance_matrix`.
"""

from typing import Callable, Dict, Optional, Sequence

from ..units import Quantity, ureg
from . import huber, hypres, ibm

__all__ = ["SQUID_LAYOUTS", "MAX_EDGE_LENGTHS", "pickup_loop_mutual", "compute_mutuals"]

#: Real-layout registry (reference ``docs/notebooks/squids/mutuals.py:27-34``;
#: the hypres layouts load digitized coordinates bundled in squids/data).
SQUID_LAYOUTS: Dict[str, Callable] = {
    "hypres-small": hypres.make_squid,
    "hypres-xsmall": hypres.make_squid_xsmall,
    "ibm-small": ibm.small.make_squid,
    "ibm-medium": ibm.medium.make_squid,
    "ibm-large": ibm.large.make_squid,
    "ibm-xlarge": ibm.xlarge.make_squid,
    "huber": huber.make_squid,
}

#: Reference meshing targets (``docs/notebooks/squids/mutuals.py:37-45``;
#: hypres-xsmall is not in the reference registry, so it reuses the
#: hypres-small target).
MAX_EDGE_LENGTHS: Dict[str, float] = {
    "hypres-small": 0.2,
    "hypres-xsmall": 0.2,
    "ibm-small": 0.1,
    "ibm-medium": 0.1,
    "ibm-large": 0.15,
    "ibm-xlarge": 0.4,
    "huber": 0.4,
}


def pickup_loop_mutual(
    device,
    iterations: int = 10,
    units: str = "Phi_0 / A",
    I_fc: str = "1 mA",
    final_refine: int = 0,
    high_precision: bool = False,
    torch_device="cuda",
) -> Quantity:
    """The pickup-loop/field-coil mutual inductance of a meshed
    susceptometer Device.

    Terminal devices drive a transport current through the field coil and
    measure the ``pl_center`` fluxoid; closed devices use the circulating-
    current mutual-inductance matrix.

    Args:
        device: The meshed susceptometer.
        iterations: Self-consistent coupling rounds.
        units: Units of the mutual inductance.
        I_fc: The field-coil current.
        final_refine: Float64 polish steps of the terminal layout's sweep
            (``solve_many(final_refine=...)``).
        high_precision: Solve at float64 accuracy around the float32
            factorizations (``solve(high_precision=True)``; for a closed
            layout, column by column).
        torch_device: ``"cuda"`` (default; raises without a card) or
            ``"cpu"``.
    """
    from ..solver import factorize_model, solve
    from ..sources import ConstantField
    from ..sweep import solve_many

    if device.terminals:
        model = factorize_model(
            device=device,
            current_units="uA",
            terminal_currents={"fc": {"source": I_fc, "drain": f"-{I_fc}"}},
            torch_device=torch_device,
        )
        if high_precision:
            solution = solve(
                model=model, iterations=iterations, high_precision=True,
                torch_device=torch_device,
            )[-1]
        else:
            # One batched sweep (B = 1): its inner rounds skip refinement.
            solution = solve_many(
                model=model,
                applied_fields=[ConstantField(0)],
                iterations=iterations,
                final_refine=final_refine,
                torch_device=torch_device,
            ).solution(0)
        mutual = sum(solution.hole_fluxoid("pl_center")) / ureg(I_fc)
    else:
        matrix = device.mutual_inductance_matrix(
            iterations=iterations, units=units, torch_device=torch_device,
            **({"high_precision": True} if high_precision else {}),
        )
        hole_names = list(device.holes)
        i = hole_names.index("pl_center")
        j = hole_names.index("fc_center")
        mutual = matrix[i, j]
    return mutual.to(units)


def compute_mutuals(
    names: Optional[Sequence[str]] = None,
    iterations: int = 10,
    smooth: int = 100,
    with_terminals: bool = True,
    max_edge_scale: float = 1.0,
    torch_device="cuda",
) -> Dict[str, Quantity]:
    """Mesh and solve each requested layout; returns
    ``{layout_name: mutual}`` in ``Phi_0 / A``.

    ``max_edge_scale`` coarsens the reference meshing targets uniformly
    (useful for quick validation runs; 1.0 reproduces the reference
    workload scale).
    """
    results = {}
    for name in names or list(SQUID_LAYOUTS):
        device = SQUID_LAYOUTS[name](with_terminals=with_terminals)
        device.make_mesh(
            max_edge_length=MAX_EDGE_LENGTHS[name] * max_edge_scale,
            smooth=smooth,
        )
        results[name] = pickup_loop_mutual(
            device, iterations=iterations, torch_device=torch_device
        )
    return results
