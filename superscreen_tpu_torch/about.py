"""Version and environment provenance.

Counterpart of ``superscreen_tpu/about.py``.  Where the JAX package
reports its backend and devices, this one reports what decides the port's
numbers on a card: the PyTorch build, its CUDA version and the CUDA
devices' names and count.
"""

import functools
import platform
import sys
from typing import Dict, Optional

__all__ = ["version_dict", "version_table"]


def version_dict() -> Dict[str, str]:
    """A dictionary of dependency versions and hardware provenance,
    embedded into every :class:`superscreen_tpu_torch.Solution` (gathered
    once per process: every Solution of a sweep embeds it)."""
    return dict(_versions())


@functools.lru_cache(maxsize=1)
def _versions() -> Dict[str, str]:
    from .version import __version__

    versions = {
        "superscreen_tpu_torch": __version__,
        "python": sys.version,
        "OS": f"{platform.system()} {platform.release()}",
        "machine": platform.machine(),
    }
    for mod_name in ("torch", "numpy", "scipy", "matplotlib", "h5py"):
        try:
            mod = __import__(mod_name)
            versions[mod_name] = str(getattr(mod, "__version__", "unknown"))
        except ImportError:
            versions[mod_name] = "not installed"
    import torch

    versions["torch_cuda"] = str(torch.version.cuda)
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    versions["cuda_devices"] = ", ".join(
        torch.cuda.get_device_name(i) for i in range(count)
    ) or "none"
    versions["cuda_device_count"] = str(count)
    return versions


def version_table(
    version_info: Optional[Dict[str, str]] = None, verbose: bool = False
):
    """An HTML table of dependency versions (for notebooks)."""
    html = [
        "<table>",
        "<tr><th>Software</th><th>Version</th></tr>",
    ]
    if version_info is None:
        version_info = version_dict()
    for name, version in version_info.items():
        if not verbose and name in ("OS", "machine"):
            continue
        html.append(f"<tr><td>{name}</td><td>{version}</td></tr>")
    html.append("</table>")
    html = "".join(html)
    try:
        from IPython.display import HTML

        return HTML(html)
    except ImportError:
        return html
