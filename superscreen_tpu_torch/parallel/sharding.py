"""Multi-device sharding for batched solves.

Counterpart of ``superscreen_tpu/parallel/sharding.py``.  One process
drives every device, a single controller as JAX's is, and every collective
is an explicit copy: ``.to(device)`` and ``torch.cat``.  Nothing here uses
``torch.distributed``.

A :class:`DeviceMesh` is a ``(data, model)`` grid of ``torch.device``s in
which a device may repeat: ``["cpu"] * 8`` runs the whole partitioning on
the CPU, ``cuda:0`` repeated runs it on one card (every split, per-shard
kernel launch, gather and row-sharded product; only the copies between
distinct cards stay unrun), ``cuda:0`` to ``cuda:k`` spread it over a
node's cards.  Two axes are used:

* ``"data"``: the sweep batch.  Each data row solves its slice of the
  right-hand sides against its own replica of the factorization, on the
  row's first slot, with no communication until the results are gathered.
* ``"model"``: rows of the dense operators.  ``Q diag(w)``, the film
  system ``A`` and the explicit inverse ``M`` of a film factorized over
  the mesh are :class:`RowSharded` over the model slots of a data row;
  each slot multiplies its own rows and the rows are gathered.

The port has no global sharded tensor.  Where the JAX function returns an
array laid out over the mesh, the port returns the gathered result on
``mesh.devices[0, 0]``, the slot that stands for the JAX array's global
view; film data and inputs split over the data axis are
:class:`ShardedFilmData` and :class:`DataSharded`, and
``sweep._run_sweep``, the one round loop behind ``solve()`` and
``solve_many()``, runs the unchanged single-device sweep once per data
row on them.  The rows run one after another from the host with no
synchronisation between them, so on distinct cards they overlap; a film
solved by CG or BiCGStab reads its residual on the host every few
iterations, which serialises the rows.
"""

import logging
import os
from dataclasses import fields, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import kernels
from ..ops.rows import RowSharded, row_bounds, schulz_inverse_rows, schur_inverse_rows

logger = logging.getLogger("parallel")

__all__ = [
    "DeviceMesh",
    "NamedSharding",
    "DataSharded",
    "ShardedFilmData",
    "RowSharded",
    "make_mesh",
    "batch_sharding",
    "replicated_sharding",
    "sharded_film_data",
    "shard_sweep_inputs",
    "sharded_biot_savart",
    "self_field_diagonal",
    "sharded_self_field",
    "sharded_spd_inverse",
    "set_factorization_mesh",
    "factorization_mesh",
]


class DeviceMesh:
    """A ``(data, model)`` grid of torch devices, the counterpart of
    ``jax.sharding.Mesh``: ``devices`` is the ``(n_data, n_model)`` object
    array, ``axis_names`` is ``("data", "model")`` and ``shape`` maps each
    axis to its size (``mesh.shape["model"]``).  A device may repeat."""

    axis_names = ("data", "model")

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 2:
            raise ValueError(f"A mesh is a 2-d grid of devices, got shape {devices.shape}.")
        self.devices = devices
        self.shape = {"data": devices.shape[0], "model": devices.shape[1]}

    def __repr__(self) -> str:
        grid = [[str(d) for d in row] for row in self.devices]
        return f"DeviceMesh(shape={self.shape}, devices={grid})"


class NamedSharding:
    """A mesh and a partition spec, the counterpart of
    ``jax.sharding.NamedSharding``: ``spec`` is a tuple of axis names (or
    None) per array axis; ``("data",)`` splits the leading axis over the
    data rows, ``()`` replicates."""

    def __init__(self, mesh: DeviceMesh, spec: Sequence = ()):
        self.mesh = mesh
        self.spec = tuple(spec)

    def __repr__(self) -> str:
        return f"NamedSharding(mesh={self.mesh!r}, spec={self.spec})"


#: When set (via :func:`set_factorization_mesh`), a low-memory film whose
#: interior exceeds the single-device dense ceiling is assembled and
#: inverted row-sharded over this mesh's ``model`` axis.
_FACTOR_MESH: Optional[DeviceMesh] = None


def set_factorization_mesh(mesh: Optional[DeviceMesh]) -> None:
    """Route the dense factorization of films past the single-device
    ceiling through ``mesh``: the ceiling rises by ``sqrt(n_model)``, such
    a film's system is assembled straight into row blocks over the model
    slots of the mesh's first data row, and it is factorized by
    :func:`sharded_spd_inverse`.  Pass None to go back to one device."""
    global _FACTOR_MESH
    _FACTOR_MESH = mesh


def factorization_mesh() -> Optional[DeviceMesh]:
    """The mesh installed by :func:`set_factorization_mesh`, if any."""
    return _FACTOR_MESH


def factorization_row_sharding() -> Optional[NamedSharding]:
    """Row sharding (``("model", None)``) over the installed factorization
    mesh, or None when no mesh with a model axis > 1 is installed: the
    layout shared by the distributed assembly of a film's system and the
    sharded inverse, so the system moves no bytes between the two."""
    mesh = _FACTOR_MESH
    if mesh is None or mesh.shape["model"] <= 1:
        return None
    return NamedSharding(mesh, ("model", None))


def _as_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"Mesh devices must be cpu or cuda devices, got {dev}.")
    return dev


def make_mesh(
    n_data: Optional[int] = None,
    n_model: int = 1,
    devices: Optional[Sequence] = None,
) -> DeviceMesh:
    """Creates a ``(data, model)`` device mesh.

    Args:
        n_data: Size of the batch axis (defaults to
            ``len(devices) // n_model``).
        n_model: Size of the matrix-row axis.
        devices: The devices (``torch.device`` or strings; one may
            repeat), default every CUDA card.  Without a card the default
            raises: there is no CPU fallback, ask for ``["cpu"] * k``.

    Returns:
        A :class:`DeviceMesh` with axes ``("data", "model")``.
    """
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise RuntimeError(
                "make_mesh() takes every CUDA card by default, and no CUDA device is "
                "available; pass devices=['cpu'] * k for a mesh on the CPU."
            )
        devices = [torch.device("cuda", i) for i in range(count)]
    devices = [_as_device(d) for d in devices]
    n_devices = len(devices)
    if n_data is None:
        n_data = n_devices // n_model
    if n_data * n_model != n_devices:
        raise ValueError(
            f"n_data * n_model ({n_data} * {n_model}) must equal the number "
            f"of devices ({n_devices})."
        )
    grid = np.empty(n_devices, dtype=object)
    grid[:] = devices
    return DeviceMesh(grid.reshape(n_data, n_model))


def batch_sharding(mesh: DeviceMesh) -> NamedSharding:
    """Sharding that puts a leading batch axis on the ``data`` mesh axis."""
    return NamedSharding(mesh, ("data",))


def replicated_sharding(mesh: DeviceMesh) -> NamedSharding:
    """Fully replicated sharding."""
    return NamedSharding(mesh, ())


def _home(mesh: DeviceMesh) -> torch.device:
    """The slot that stands for a sharded result's global view."""
    return mesh.devices[0, 0]


def _round_up_div(n, m):
    return -(-n // m) * m


def _tensor(x, device=None) -> torch.Tensor:
    t = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
    return t if device is None else t.to(device)


class DataSharded:
    """A batch split over the data rows of a mesh: ``parts[r]`` holds rows
    ``bounds[r]`` of the leading axis, on ``mesh.devices[r, 0]``.
    ``np.asarray`` concatenates the parts."""

    def __init__(self, parts: List[torch.Tensor], bounds: List[Tuple[int, int]], mesh: DeviceMesh):
        self.parts = parts
        self.bounds = bounds
        self.mesh = mesh
        self.shape = (bounds[-1][1],) + tuple(parts[0].shape[1:])

    @classmethod
    def split(cls, value, mesh: DeviceMesh) -> "DataSharded":
        """``value`` (a tensor or array) split by :func:`rows.row_bounds`
        over the data rows (the parts of a tensor on a row's own device
        are views)."""
        t = _tensor(value)
        bounds = row_bounds(t.shape[0], mesh.shape["data"])
        return cls([t[lo:hi].to(mesh.devices[r, 0]) for r, (lo, hi) in enumerate(bounds)], bounds, mesh)

    def __array__(self, dtype=None, copy=None):
        out = np.concatenate([p.detach().cpu().numpy() for p in self.parts])
        return out if dtype is None else out.astype(dtype)

    def __repr__(self) -> str:
        return f"DataSharded(shape={self.shape}, bounds={self.bounds})"


class ShardedFilmData(dict):
    """``{film_name: FilmSweepData}`` placed on a mesh: ``rows[r]`` is data
    row ``r``'s replica (its tensors on ``mesh.devices[r, 0]``, the dense
    operators :class:`RowSharded` over ``mesh.devices[r, :]``), and the
    mapping itself is row 0's, the global view."""

    def __init__(self, rows: List[Dict[str, object]], mesh: DeviceMesh):
        super().__init__(rows[0])
        self.rows = rows
        self.mesh = mesh


def _replicate(value, device: torch.device):
    """``value`` with every tensor inside it on ``device`` (tensors,
    dicts, tuples, named tuples and lists; anything else as it is)."""
    if torch.is_tensor(value):
        return value.to(device)
    if isinstance(value, dict):
        return {k: _replicate(v, device) for k, v in value.items()}
    if isinstance(value, tuple) and hasattr(value, "_fields"):
        return type(value)(*(_replicate(v, device) for v in value))
    if isinstance(value, (tuple, list)):
        return type(value)(_replicate(v, device) for v in value)
    return value


def _row_placed(value, slots: Sequence[torch.device]):
    """A dense operator over the model slots ``slots``: a
    :class:`RowSharded` (resharded, or split from a tensor) where there are
    several slots, the tensor on the slot where there is one."""
    if value is None:
        return None
    if isinstance(value, RowSharded):
        return value.reshard(slots)
    if len(slots) == 1:
        return value.to(slots[0])
    return RowSharded.split(value, slots)


def _replica(data, slots: Sequence[torch.device]):
    """Film sweep data for one data row: the operators that only products
    consume (``Qw``, ``A``, and the explicit inverse of a film factorized
    over a mesh) row-sharded over its model slots, everything else on its
    first slot (LU and Cholesky factors feed triangular solves and are
    replicated)."""
    kwargs = {}
    for f in fields(data):
        value = getattr(data, f.name)
        if f.name in ("Qw", "A"):
            kwargs[f.name] = _row_placed(value, slots)
        elif f.name == "factors" and data.fac_kind == "inv":
            _, M, w = value
            kwargs[f.name] = ("inv", _row_placed(M, slots), None if w is None else w.to(slots[0]))
        else:
            kwargs[f.name] = _replicate(value, slots[0])
    return replace(data, **kwargs)


def _zero_padded(t: Optional[torch.Tensor], axis: int, pad: int) -> Optional[torch.Tensor]:
    if t is None:
        return None
    shape = list(t.shape)
    shape[axis] = pad
    return torch.cat([t, torch.zeros(shape, dtype=t.dtype, device=t.device)], dim=axis)


def _pad_film_site_axis(data, n_model: int):
    """Pads a film's sweep data on the site axis so ``n`` divides the
    ``model`` mesh axis, making ``Q diag(w)`` row-shardable.

    Padded sites are placed at distinct far-away coordinates (so every
    pairwise kernel stays finite) with unit vertex weight; their current
    density is exactly zero (their rows of the gather tables have zero
    weight), so they contribute nothing as Biot-Savart sources, and they
    are never interior sites, so they contribute nothing to any solve.
    A film whose self-field is applied matrix-free (no ``Qw``) gets the
    Brandt diagonal ``C + q @ w`` of its own sites (``brandt_diag``): the
    boundary vector ``C`` depends on the sites' extent, which the far
    pads would change.  ``interior`` is never padded.  Returns new sweep
    data with ``n`` the padded size.
    """
    n = data.n
    n_p = _round_up_div(n, n_model)
    pad = n_p - n
    if pad == 0:
        return data
    if data.fft_grid is not None:
        # The FFT-coupling grid data indexes the unpadded sites; padding
        # underneath it would corrupt the interpolation.
        logger.warning(
            f"Film {data.name!r}: not padding the site axis because FFT "
            "coupling grid data is attached; Q diag(w) splits into row blocks "
            "that differ by one row."
        )
        return data
    brandt = data.brandt_diag
    if brandt is None and data.Qw is None and not data.terminal:
        brandt = kernels.C_vector(data.sites) + kernels.q_apply(data.sites, data.weights)
    Qw = None
    if data.Qw is not None:
        Qw = torch.zeros((n_p, n_p), dtype=data.Qw.dtype, device=data.Qw.device)
        Qw[:n, :n] = data.Qw
    last = lambda t: None if t is None else _zero_padded(t, t.ndim - 1, pad)  # noqa: E731
    return replace(
        data,
        n=n_p,
        sites=_pad_sites(data.sites, pad),
        weights=torch.cat([data.weights, torch.ones(pad, dtype=data.weights.dtype, device=data.weights.device)]),
        Qw=Qw,
        hole_masks=_zero_padded(data.hole_masks, 1, pad),
        hole_ha_vecs=_zero_padded(data.hole_ha_vecs, 1, pad),
        g_offset=last(data.g_offset),
        ha_offset=last(data.ha_offset),
        # Gather-form gradients: padded sites read site 0 with weight 0.
        gx_idx=_zero_padded(data.gx_idx, 0, pad),
        gx_w=_zero_padded(data.gx_w, 0, pad),
        gy_idx=_zero_padded(data.gy_idx, 0, pad),
        gy_w=_zero_padded(data.gy_w, 0, pad),
        brandt_diag=_zero_padded(brandt, 0, pad),
    )


def sharded_film_data(film_data: Dict[str, object], mesh: DeviceMesh, pad_to_shardable: bool = True):
    """Places each film's sweep data on the mesh: ``Q diag(w)``, the
    system ``A`` (refinement residuals) and the explicit inverse of an
    ``"inv"`` film are row-sharded over each data row's model slots (all
    product-only consumers); LU and Cholesky factors and everything else are
    replicated to each data row's first slot (triangular solves do not
    split by rows).

    Args:
        film_data: ``{film_name: FilmSweepData}`` of
            :mod:`superscreen_tpu_torch.sweep`.
        mesh: The device mesh.
        pad_to_shardable: Pad each film's site axis (far-away zero-weight
            sites) so ``n`` divides the ``model`` axis and ``Q diag(w)``
            splits into equal row blocks.  Build sweep inputs from the
            returned films' ``n`` (or pass the returned data to
            :func:`shard_sweep_inputs` to pad inputs built for the
            unpadded meshes).  ``A`` is never padded: a system whose rows
            do not divide the model axis splits into blocks that differ
            by one row.

    Returns:
        A :class:`ShardedFilmData`.
    """
    n_model = mesh.shape["model"]
    if pad_to_shardable and n_model > 1:
        film_data = {name: _pad_film_site_axis(d, n_model) for name, d in film_data.items()}
    rows = [
        {name: _replica(data, list(mesh.devices[r])) for name, data in film_data.items()}
        for r in range(mesh.shape["data"])
    ]
    return ShardedFilmData(rows, mesh)


def shard_sweep_inputs(
    Hz_applied: Dict[str, np.ndarray],
    I_circ: Dict[str, np.ndarray],
    mesh: DeviceMesh,
    film_data: Optional[Dict[str, object]] = None,
) -> Tuple[Dict, Dict]:
    """Splits the sweep right-hand sides over the ``data`` axis
    (:class:`DataSharded`).

    Pass ``film_data`` (the data returned by :func:`sharded_film_data`)
    when the applied fields were built against the unpadded meshes: each
    film's ``Hz`` is zero-padded on the site axis to that film's (possibly
    padded) ``n``.  Padded sites are never interior sites, so the pad
    values are inert.
    """
    Hz = {}
    for k, v in Hz_applied.items():
        t = _tensor(v)
        if film_data is not None and film_data[k].n > t.shape[1]:
            t = _zero_padded(t, 1, film_data[k].n - t.shape[1])
        Hz[k] = DataSharded.split(t, mesh)
    Ic = {k: DataSharded.split(v, mesh) for k, v in I_circ.items()}
    return Hz, Ic


def _sites_like(sites, like: torch.Tensor) -> torch.Tensor:
    return _tensor(sites).to(dtype=like.dtype, device=like.device)


def sharded_biot_savart(mesh, src_sites, src_areas, J, dst_sites, dz2):
    """Inter-film Biot-Savart with the ``O(n_src * n_dst)`` work split over
    the mesh: destination rows over ``model``, the sweep batch over
    ``data``.  Sources are replicated, so no block needs another's data:
    each ``(data, model)`` block is one ``biot_savart_batch`` call on its
    slot's device (the plain version for a CPU slot), and the blocks are
    gathered.  As in the JAX package the destinations and the batch are
    zero-padded to shard-divisible sizes; a block that holds only padding
    is not computed.

    Args:
        mesh: ``(data, model)`` mesh from :func:`make_mesh`.
        src_sites: ``(n_src, 2)`` source sites.
        src_areas: ``(n_src,)`` vertex areas.
        J: ``(B, n_src, 2)`` batched sheet current.
        dst_sites: ``(n_dst, 2)`` evaluation sites.
        dz2: Squared layer separation.

    Returns:
        ``(B, n_dst)`` field on ``mesh.devices[0, 0]``.
    """
    J = _tensor(J)
    src_sites, src_areas, dst_sites = (_sites_like(a, J) for a in (src_sites, src_areas, dst_sites))
    n_dst, B = dst_sites.shape[0], J.shape[0]
    n_data, n_model = mesh.shape["data"], mesh.shape["model"]
    dst_p = _zero_padded(dst_sites, 0, _round_up_div(n_dst, n_model) - n_dst)
    J_p = _zero_padded(J, 0, _round_up_div(B, n_data) - B)
    rows_d, rows_m = J_p.shape[0] // n_data, dst_p.shape[0] // n_model
    home = _home(mesh)
    out = torch.zeros((J_p.shape[0], dst_p.shape[0]), dtype=J.dtype, device=home)
    for d in range(n_data):
        b0 = d * rows_d
        if b0 >= B:
            continue
        for m in range(n_model):
            r0 = m * rows_m
            if r0 >= n_dst:
                continue
            dev = mesh.devices[d, m]
            block = kernels.biot_savart_film_to_film_dz2(
                src_sites.to(dev), src_areas.to(dev), J_p[b0 : b0 + rows_d].to(dev),
                dst_p[r0 : r0 + rows_m].to(dev), dz2,
            )
            out[b0 : b0 + rows_d, r0 : r0 + rows_m] = block.to(home)
    return out[:B, :n_dst]


def self_field_diagonal(mesh, sites, weights):
    """The regularised Brandt diagonal ``(C + q @ w) / w`` with the
    ``O(n^2)`` row sums split over the ``model`` axis (one ``q_apply`` per
    slot of the first data row, on its device; the ``O(n)`` boundary
    vector ``C`` on the home slot).  Returns ``(n,)`` on
    ``mesh.devices[0, 0]``, for reuse across :func:`sharded_self_field`
    calls."""
    home = _home(mesh)
    sites = _tensor(sites, home)
    weights = _tensor(weights).to(dtype=sites.dtype, device=home)
    n = sites.shape[0]
    n_model = mesh.shape["model"]
    sites_p = _pad_sites(sites, _round_up_div(n, n_model) - n)
    rows = sites_p.shape[0] // n_model
    q_row_w = torch.zeros(sites_p.shape[0], dtype=sites.dtype, device=home)
    for m in range(n_model):
        r0 = m * rows
        if r0 >= n:
            continue
        dev = mesh.devices[0, m]
        q_row_w[r0 : r0 + rows] = kernels.q_apply_rect(
            sites_p[r0 : r0 + rows].to(dev), sites.to(dev), weights.to(dev)
        ).to(home)
    return (kernels.C_vector(sites) + q_row_w[:n]) / weights


def _pad_sites(sites: torch.Tensor, pad: int) -> torch.Tensor:
    """Append ``pad`` sites far away from the geometry (distinct
    coordinates, so kernel distances stay finite)."""
    if pad == 0:
        return sites
    span = torch.max(torch.abs(sites)) + 1.0
    coords = 1e6 * span * (1.0 + torch.arange(pad, dtype=sites.dtype, device=sites.device))
    return torch.cat([sites, torch.stack([coords, coords], dim=1)])


def sharded_self_field(mesh, sites, weights, g, diag=None):
    """Self-field ``Q @ (w * g)`` with rows split over ``model`` and the
    batch over ``data``: each block is one ``q_apply`` of its row block of
    sites against all sites on its slot's device; the ``O(n)`` diagonal
    term is added on the gathered result.

    Args:
        mesh: ``(data, model)`` mesh.
        sites: ``(n, 2)`` mesh sites.
        weights: ``(n,)`` vertex areas.
        g: ``(B, n)`` stream functions.
        diag: Optional Brandt diagonal from :func:`self_field_diagonal`,
            to skip its ``O(n^2 / n_model)`` row sums on repeated calls.

    Returns:
        ``(B, n)`` self-field on ``mesh.devices[0, 0]``.
    """
    home = _home(mesh)
    g = _tensor(g, home)
    sites = _sites_like(sites, g)
    weights = _sites_like(weights, g)
    n, B = sites.shape[0], g.shape[0]
    n_data, n_model = mesh.shape["data"], mesh.shape["model"]
    if diag is None:
        diag = self_field_diagonal(mesh, sites, weights)
    sites_p = _pad_sites(sites, _round_up_div(n, n_model) - n)
    wg = weights[None, :] * g
    wg_p = _zero_padded(wg, 0, _round_up_div(B, n_data) - B)
    rows_d, rows_m = wg_p.shape[0] // n_data, sites_p.shape[0] // n_model
    off_diag = torch.zeros((wg_p.shape[0], sites_p.shape[0]), dtype=g.dtype, device=home)
    for d in range(n_data):
        b0 = d * rows_d
        if b0 >= B:
            continue
        for m in range(n_model):
            r0 = m * rows_m
            if r0 >= n:
                continue
            dev = mesh.devices[d, m]
            block = kernels.q_apply_rect(
                sites_p[r0 : r0 + rows_m].to(dev), sites.to(dev), wg_p[b0 : b0 + rows_d].to(dev).T
            )
            off_diag[b0 : b0 + rows_d, r0 : r0 + rows_m] = -block.T.to(home)
    return off_diag[:B, :n] + _tensor(diag, home)[None, :] * wg


def _inverse_method(method: Optional[str]) -> str:
    if method is None:
        method = os.environ.get("SUPERSCREEN_TPU_SHARDED_FACTOR", "schur")
    if method not in ("schur", "schulz"):
        raise ValueError(
            f"Unknown sharded factorization method {method!r} "
            "(expected 'schur' or 'schulz')."
        )
    return method


def _sharded_inverse(mesh, A, w_col, sign: float, method: Optional[str]) -> RowSharded:
    """The solution operator of ``(-S) x = h`` for the system ``S = sign *
    A`` (``P = S / w``), row-sharded over the model slots of the mesh's
    first data row."""
    method = _inverse_method(method)  # before anything is copied
    slots = list(mesh.devices[0])
    A = A.reshard(slots) if isinstance(A, RowSharded) else RowSharded.split(_tensor(A), slots)
    w = _tensor(w_col).to(dtype=A.dtype, device=A.device)
    body = schulz_inverse_rows if method == "schulz" else schur_inverse_rows
    return body(A, w, sign=sign)


def sharded_spd_inverse(mesh, neg_A, w_col, method: Optional[str] = None):
    """Explicit inverse of the Brandt system, row-sharded over the mesh's
    ``model`` axis: each slot holds ``n / n_model`` rows of at most
    three ``n x n`` matrices at once, the system among them, and a few
    ``(n, PANEL)`` panels (:mod:`superscreen_tpu_torch.ops.rows`), so a
    film beyond one card's memory can stay dense on several.

    Args:
        mesh: ``(data, model)`` mesh; the inverse lives on the model slots
            of its first data row (:func:`sharded_film_data` replicates it
            to the others).
        neg_A: The negated film system ``-A``: a tensor or array, or a
            :class:`RowSharded` (resharded over the slots where needed).
        w_col: Column weights such that ``-A / w`` is SPD.
        method: ``"schur"`` (default; block Gauss-Jordan over pivot panels
            plus one Schulz correction, ~4 n^3 multiply-adds) or
            ``"schulz"`` (Schulz-Hotelling iteration, ~3 n^3 per step, 24
            steps, self-correcting).  Defaults to
            ``SUPERSCREEN_TPU_SHARDED_FACTOR``; validated before anything
            is copied.

    Returns the solution operator ``M`` (``x = M @ h`` solves
    ``(-A) x = h``) as a :class:`RowSharded`.
    """
    return _sharded_inverse(mesh, neg_A, w_col, -1.0, method)


def sharded_inverse_of_system(mesh, A, w_col, method: Optional[str] = None) -> RowSharded:
    """:func:`sharded_spd_inverse` of ``-A`` from the system ``A`` itself
    (the negation folds into the column scaling, so no negated copy is
    made).  ``A`` is only read: it stays the caller's, for the
    refinement residuals."""
    return _sharded_inverse(mesh, A, w_col, 1.0, method)


def batch_mesh(sharding, torch_device) -> DeviceMesh:
    """The mesh of a ``solve_many`` / scan ``sharding``: a
    :class:`NamedSharding` whose spec starts with ``"data"`` and whose
    slots are all devices of ``torch_device``'s type.  Anything else
    raises ``TypeError`` or ``ValueError`` naming what it got."""
    if not isinstance(sharding, NamedSharding):
        raise TypeError(
            "sharding must be a superscreen_tpu_torch.parallel NamedSharding "
            f"(batch_sharding(make_mesh(...))), got {type(sharding).__name__}."
        )
    if not sharding.spec or sharding.spec[0] != "data":
        raise ValueError(
            f"sharding must split the batch over the 'data' axis (spec ('data',)), "
            f"got spec {sharding.spec}."
        )
    kind = torch.device(torch_device).type
    others = sorted({str(d) for d in sharding.mesh.devices.flat if d.type != kind})
    if others:
        raise ValueError(
            f"The sharding's mesh holds {others}, not devices of the solve's "
            f"torch_device {torch_device}."
        )
    return sharding.mesh
