"""HDF5 serialization helpers.

Counterpart of ``superscreen_tpu/io.py``, with the same on-disk
conventions, so that files stay readable by both packages: arbitrary
Python objects (applied-field callables, position-dependent ``Parameter``
penetration depths) are dill-pickled into ``np.void`` attributes or
datasets named ``<name>.pickle``.  :func:`h5_context` is the shared
open-file-or-group adapter of every ``to_hdf5``/``from_hdf5`` in the
package.

``h5py`` and ``dill`` are imported by the call that needs them, so the
package imports without them; a missing one raises ``ImportError`` naming
it.
"""

from contextlib import contextmanager, nullcontext
from typing import Any

import numpy as np

__all__ = ["serialize_obj", "deserialize_obj", "h5_context", "new_group", "require"]

_PICKLE_SUFFIX = ".pickle"


def require(module: str):
    """Imports ``module`` (``"h5py"``, ``"dill"``, ``"matplotlib.pyplot"``,
    ...), raising ``ImportError`` that names the package if it is absent."""
    import importlib

    try:
        return importlib.import_module(module)
    except ImportError as err:
        package = module.split(".")[0]
        raise ImportError(
            f"This operation needs the {package!r} package, which is not installed."
        ) from err


@contextmanager
def h5_context(path_or_group, mode: str):
    """Yield an :class:`h5py.Group`, opening ``path_or_group`` as a file if
    it is not already an open group."""
    h5py = require("h5py")
    if isinstance(path_or_group, h5py.Group):
        ctx = nullcontext(path_or_group)
    else:
        ctx = h5py.File(path_or_group, mode)
    with ctx as group:
        yield group


def new_group(parent, name: str):
    """``parent.create_group(name)`` that keeps its members in creation
    order: films, layers and holes then load in the order they were
    written, and so does every sum over them (a reloaded model solves to
    the same bits).  Files of the JAX package list members alphabetically,
    which both packages read alike."""
    return parent.create_group(name, track_order=True)


def _pickled(obj: Any) -> np.void:
    return np.void(require("dill").dumps(obj))


def _unpickled(raw) -> Any:
    return require("dill").loads(np.void(raw).tobytes())


def serialize_obj(group, obj: Any, name: str, attr: bool = False) -> None:
    """Serialize ``obj`` into the ``h5py.Group`` ``group`` under ``name``.

    With ``attr=True``, natively-storable values (numbers, strings, small
    arrays) become plain HDF5 attributes; anything else falls back to a
    dill-pickled ``<name>.pickle`` attribute.  Without ``attr``, the object
    is always pickled into a dataset.
    """
    if not attr:
        group[name + _PICKLE_SUFFIX] = _pickled(obj)
        return
    try:
        group.attrs[name] = obj
    except TypeError:
        group.attrs[name + _PICKLE_SUFFIX] = _pickled(obj)


def deserialize_obj(group, name: str, attr: bool = False) -> Any:
    """Inverse of :func:`serialize_obj`."""
    pickled_name = name + _PICKLE_SUFFIX
    if attr:
        if name in group.attrs:
            return group.attrs[name]
        if pickled_name in group.attrs:
            return _unpickled(group.attrs[pickled_name])
    elif pickled_name in group:
        return _unpickled(group[pickled_name][()])
    raise IOError(f"Unable to load {name}.")
