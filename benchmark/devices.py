"""The program's devices of a configuration: polygons from the
configuration file, meshes from the frozen files under ``benchmark/data``
(each checked against its recorded sha256 before it is read).  No run
meshes; ``make_meshes.py`` wrote the files once."""

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


def polygons(st, spec: dict, group: str):
    return [
        st.Polygon(p["name"], layer=p["layer"], points=st.geometry.circle(p["circle"][0], points=p["circle"][1]))
        for p in spec.get(group, [])
    ]


def build_device(st, name: str, spec: dict, solve_dtype: str, meshed: bool = True):
    """The program's ``Device`` of ``spec``, with its frozen meshes loaded
    through ``Mesh.from_triangulation`` unless ``meshed`` is False."""
    device = st.Device(
        name,
        layers=[st.Layer(l["name"], Lambda=l["Lambda"], z0=l["z0"]) for l in spec["layers"]],
        films=polygons(st, spec, "films"),
        holes=polygons(st, spec, "holes"),
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
