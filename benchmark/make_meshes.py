"""Meshes each device of a configuration once with the program's own
``Device.make_mesh`` at the settings in the configuration file, writes
each film's sites (float64) and elements (int32) to
``benchmark/data/<config>/<film>.npz`` and records each file's path,
sha256 and sizes in the configuration file.

    python3 benchmark/make_meshes.py four_ring_27k scan_config5
"""

import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark.devices import ROOT, build_device, sha256  # noqa: E402


def main(names):
    import superscreen_tpu_torch as st

    for name in names:
        path = ROOT / "benchmark" / "configs" / f"{name}.json"
        config = json.loads(path.read_text())
        out = ROOT / "benchmark" / "data" / name
        out.mkdir(parents=True, exist_ok=True)
        for dev_name, spec in config["devices"].items():
            device = build_device(st, dev_name, spec, config["solve_dtype"], meshed=False)
            device.make_mesh(**spec["mesh"])
            for film, mesh in device.meshes.items():
                file = out / f"{film}.npz"
                np.savez_compressed(file, sites=mesh.sites.astype(np.float64), elements=mesh.elements.astype(np.int32))
                spec["files"][film] = {
                    "file": str(file.relative_to(ROOT)), "sha256": sha256(file),
                    "sites": int(len(mesh.sites)), "elements": int(len(mesh.elements)),
                }
                print(name, dev_name, film, spec["files"][film])
        path.write_text(json.dumps(config, indent=2) + "\n")


if __name__ == "__main__":
    main(sys.argv[1:])
