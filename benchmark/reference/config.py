"""The reference's reading of a configuration: each film's
:class:`~benchmark.reference.mesh.FilmMesh` from the configuration file
and the frozen mesh files (read here, by the reference itself)."""

from pathlib import Path
from typing import Dict, List

import numpy as np

from .mesh import circle, closed_ccw, film_mesh, points_in_ring

ROOT = Path(__file__).resolve().parent.parent.parent

#: SI values (the 2019 redefinition; mu_0 as CODATA 2018 gives it).
MU_0 = 1.25663706212e-6
PHI_0 = 6.62607015e-34 / (2 * 1.602176634e-19)
#: Solver units of the applied field: current / length, here uA/um = A/m.
FIELD_PER_MT = 1e-3 / MU_0


def _ring(p: dict) -> np.ndarray:
    """A polygon's vertices: its ``points``, or its ``circle`` [radius,
    points] about the origin."""
    if "points" in p:
        return np.asarray(p["points"], dtype=np.float64)
    return circle(p["circle"][0], p["circle"][1])


def load_mesh(entry: dict):
    with np.load(ROOT / entry["file"]) as data:
        return np.asarray(data["sites"], dtype=np.float64), np.asarray(data["elements"], dtype=np.int64)


def film_meshes(spec: dict, Lambda: Dict[str, float] = None) -> List:
    """The films of device ``spec``, with each layer's ``Lambda`` taken from
    the configuration or, per layer name, from ``Lambda``."""
    layers = {l["name"]: l for l in spec["layers"]}
    out = []
    for f in spec["films"]:
        outline = _ring(f)
        holes = {
            h["name"]: _ring(h) for h in spec.get("holes", [])
            if h["layer"] == f["layer"] and points_in_ring(closed_ccw(outline), _ring(h)).all()
        }
        sites, elements = load_mesh(spec["files"][f["name"]])
        layer = layers[f["layer"]]
        lam = layer["Lambda"] if Lambda is None else Lambda[f["layer"]]
        out.append(film_mesh(f["name"], sites, elements, outline, holes, lam, layer["z0"]))
    return out
