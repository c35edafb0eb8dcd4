"""The program's devices of a configuration: polygons from the
configuration file, meshes from the frozen files under ``benchmark/data``
(each checked against its recorded sha256 before it is read).  No run
meshes; ``make_meshes.py`` wrote the files once.

A polygon is ``{"name", "layer", "circle": [radius, points]}`` (a circle
about the origin) or ``{"name", "layer", "points": [[x, y], ...]}`` (its
vertices).  A film may list ``terminals``, polygons of the same form
(``layer`` may be left out), passed to ``Device(terminals=)``."""

import hashlib
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def sha256(path: Path) -> str:
    return hashlib.sha256(Path(path).read_bytes()).hexdigest()


def frozen_mesh(entry: dict):
    """``(sites float64, elements)`` of a frozen mesh file, after its hash
    is checked."""
    path = ROOT / entry["file"]
    digest = sha256(path)
    if digest != entry["sha256"]:
        raise ValueError(f"{entry['file']}: sha256 {digest} is not the recorded {entry['sha256']}.")
    with np.load(path) as data:
        return np.asarray(data["sites"], dtype=np.float64), np.asarray(data["elements"])


def polygon(st, p: dict):
    """The program's ``Polygon`` of a polygon of the configuration file."""
    if "points" in p:
        points = np.asarray(p["points"], dtype=np.float64)
    else:
        points = st.geometry.circle(p["circle"][0], points=p["circle"][1])
    return st.Polygon(p["name"], layer=p.get("layer"), points=points)


def polygons(st, spec: dict, group: str):
    return [polygon(st, p) for p in spec.get(group, [])]


def terminals(st, spec: dict):
    """``{film: [terminal Polygon, ...]}`` of the films that list any."""
    return {
        f["name"]: [polygon(st, t) for t in f["terminals"]]
        for f in spec["films"] if f.get("terminals")
    }


def build_device(st, name: str, spec: dict, solve_dtype: str, meshed: bool = True):
    """The program's ``Device`` of ``spec``, with its frozen meshes loaded
    through ``Mesh.from_triangulation`` unless ``meshed`` is False."""
    device = st.Device(
        name,
        layers=[st.Layer(l["name"], Lambda=l["Lambda"], z0=l["z0"]) for l in spec["layers"]],
        films=polygons(st, spec, "films"),
        holes=polygons(st, spec, "holes"),
        terminals=terminals(st, spec),
        abstract_regions=polygons(st, spec, "abstract_regions"),
        length_units=spec["length_units"],
        solve_dtype=solve_dtype,
    )
    if meshed:
        from superscreen_tpu_torch.device.mesh import Mesh

        device.meshes = {
            film: Mesh.from_triangulation(*frozen_mesh(spec["files"][film])) for film in device.films
        }
    return device
