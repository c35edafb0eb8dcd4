"""Differentiable (adjoint) solves for inverse design.

Counterpart of ``superscreen_tpu/adjoint.py``: the Brandt stream-function
solve of a meshed :class:`Device` as a function of its physical
parameters, differentiated by ``torch.autograd``.  Gradients reach

* the penetration depth ``Lambda`` at every mesh site,
* the applied field at the mesh sites,
* circulating (hole) currents, vortex fluxoid counts ``nPhi0`` and
  terminal currents,

at the cost of one transposed solve per solve (the backward pass of
:class:`ops.autograd.BrandtSolve`), not of differentiating an iterative
loop.  The forward model follows the JAX package's
(``superscreen_tpu/adjoint.py:182-271``, ``:359-447``): the system
``A = Q diag(w) - Lambda nabla^2 - (grad Lambda) . grad``, the hole
boundary conditions, the transport bootstrap of a film with terminals,
the vortex response columns, the sheet currents and screening field, and
``iterations`` rounds of inter-film Biot-Savart coupling.

What is computed where:

* Everything independent of Lambda is built once, by
  :func:`build_adjoint_model`, on the torch device: per film
  ``Qw = Q diag(w)`` (``Q`` through the ``q_matrix`` kernel), the sparse
  pattern through which Lambda enters ``A`` and the map from Lambda to
  its values, the gradient operators in gather form (and their
  transposes), and the geometry of the transport bootstrap.
* Per call of the forward function, each film's interior system
  ``A[ix, ix]`` is assembled and LU-factorized once, outside the graph:
  Lambda is the same in every coupling round, so the one factorization
  serves the rounds, the vortex columns and the transport bootstrap (the
  JAX package factorizes in every round).  A terminal film with holes
  gets a second LU, of its film-without-boundary block.
* The parts of a film's solve that do not depend on the coupling field
  (hole and transport streams, their effective field, the vortex
  response) are computed once per call; each round solves only the
  field-dependent right-hand sides.
* ``applied_field[film]`` may be ``(n,)`` or a batch ``(B, n)``: a batch
  is ``B`` right-hand sides against the same LU (what ``jax.vmap`` over
  the drive amounts to) and the outputs get a leading ``B``.
"""

from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import scipy.sparse
import torch

from .device import Device
from .geometry import close_curve, path_vectors
from .ops import kernels
from .ops.autograd import (
    BiotSavartCoupling,
    BrandtSolve,
    DenseProduct,
    FactoredSystem,
    SparseMatvec,
    SparsePattern,
)
from .solution import Vortex
from .solver.solve import highest_matmul_precision, resolve_torch_device
from .solver.solve_film import boundary_stream_from_indices
from .solver.utils import field_conversion_factor, make_film_info, torch_dtype
from .sweep import vortex_flux_quantum

__all__ = ["AdjointModel", "FilmAdjointData", "SparseOperator", "build_adjoint_model"]

_ONE_OVER_4PI = 1 / (4 * np.pi)


@dataclass(frozen=True)
class SparseOperator:
    """A constant sparse operator: its :class:`SparsePattern` and values."""

    pattern: SparsePattern
    vals: torch.Tensor

    @staticmethod
    def from_coo(rows, cols, vals, shape, dtype, torch_device) -> "SparseOperator":
        return SparseOperator(
            SparsePattern.from_coo(rows, cols, shape, torch_device),
            torch.as_tensor(np.asarray(vals), dtype=dtype, device=torch_device),
        )

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return SparseMatvec.apply(self.vals, x, self.pattern)


@dataclass(frozen=True)
class SystemBlock:
    """The rows and columns ``index`` of a film's system and the entries
    of the Lambda pattern that fall in them (``entries``, at ``rows``,
    ``cols`` within the block)."""

    index: torch.Tensor
    mask: torch.Tensor
    entries: torch.Tensor
    rows: torch.Tensor
    cols: torch.Tensor

    @staticmethod
    def build(index: np.ndarray, pattern_rows, pattern_cols, n: int, dtype, torch_device):
        pos = np.full(n, -1, dtype=np.int64)
        pos[index] = np.arange(len(index))
        entries = np.flatnonzero((pos[pattern_rows] >= 0) & (pos[pattern_cols] >= 0))
        mask = np.zeros(n)
        mask[index] = 1.0

        def tensor(a, **kw):
            return torch.as_tensor(a, device=torch_device, **kw)

        return SystemBlock(
            index=tensor(np.asarray(index, dtype=np.int64)),
            mask=tensor(mask, dtype=dtype),
            entries=tensor(entries),
            rows=tensor(pos[pattern_rows[entries]]),
            cols=tensor(pos[pattern_cols[entries]]),
        )

    def factor(self, Qw: torch.Tensor, vals: torch.Tensor) -> FactoredSystem:
        """``A[index, index] = Qw[index, index] + S(vals)[index, index]``,
        LU-factorized (outside the graph; each pattern position occurs
        once, so the scatter adds one value per entry)."""
        ix = self.index
        A = Qw[ix[:, None], ix[None, :]]
        A.index_put_((self.rows, self.cols), vals[self.entries], accumulate=True)
        return FactoredSystem.factor(A, ix, Qw.shape[0])


@dataclass
class FilmAdjointData:
    """Static per-film tensors of the differentiable forward model.

    Everything here is independent of the parameters: ``Qw = Q diag(w)``,
    the pattern of ``A``'s Lambda terms (``lambda_pattern``: the
    Laplacian's and the two ``(grad Lambda) . grad`` terms' positions,
    merged) and the linear map ``lambda_map`` from Lambda to their values,
    the vertex (and, for a film with terminals, triangle) gradient
    operators, and the solver index sets.
    """

    name: str
    n: int
    hole_names: Tuple[str, ...]
    vortex_rows: Tuple[int, ...]  # positions within `interior`
    vortex_sites: Tuple[int, ...]  # global mesh indices
    sites: torch.Tensor  # (n, 2)
    weights: torch.Tensor  # (n,) vertex areas
    Qw: torch.Tensor  # (n, n)
    lambda_pattern: SparsePattern
    lambda_map: SparseOperator  # Lambda (n,) -> values (nnz,), float64
    gradient_x: SparseOperator
    gradient_y: SparseOperator
    interior: np.ndarray  # the solve's index set (host)
    interior_block: SystemBlock
    hole_masks: torch.Tensor  # (n_holes, n)
    z0: float
    default_Lambda: torch.Tensor  # (n,)
    vortex_rhs: Optional[torch.Tensor] = None  # (n_vortices, n) unit rows
    # --- transport terminals (None for films without terminals) ---
    terminal_names: Tuple[str, ...] = ()
    # The film without its boundary; None when it equals `interior`.
    fwb_block: Optional[SystemBlock] = None
    boundary_index: Optional[torch.Tensor] = None  # (nb,) CCW boundary
    boundary_mask: Optional[torch.Tensor] = None
    term_unit_streams: Optional[torch.Tensor] = None  # (nt, n)
    boundary_kernel: Optional[torch.Tensor] = None  # (n, nb)
    tri_centroids: Optional[torch.Tensor] = None  # (m, 2)
    tri_areas: Optional[torch.Tensor] = None  # (m,)
    gradient_tri_x: Optional[SparseOperator] = None
    gradient_tri_y: Optional[SparseOperator] = None

    def A_apply(self, vals: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """``A @ u`` for ``(k, n)`` rows ``u``: ``Qw u + S(vals) u``."""
        return DenseProduct.apply(u, self.Qw) + SparseMatvec.apply(vals, u, self.lambda_pattern)


def _lambda_operators(ops, n: int):
    """The merged pattern of ``A``'s Lambda terms and the map ``P`` with
    ``values = P Lambda`` (host, float64): entry ``k`` of the Laplacian
    adds ``-lap_k Lambda[col_k]`` at its position, entry ``k`` of ``gx``
    adds ``-gx_k (gx @ Lambda)[row_k]`` (``adjoint.py:198-205``), and
    entries sharing a position are merged, so that every position occurs
    once."""
    lap, gx, gy = ops.laplacian, ops.gradient_x, ops.gradient_y
    rows = np.concatenate([lap.rows, gx.rows, gy.rows]).astype(np.int64)
    cols = np.concatenate([lap.cols, gx.cols, gy.cols]).astype(np.int64)
    keys, where = np.unique(rows * n + cols, return_inverse=True)
    u_lap, u_gx, u_gy = np.split(where.ravel(), [len(lap.rows), len(lap.rows) + len(gx.rows)])
    nnz = len(keys)

    def entries(vals, u, c):
        return scipy.sparse.coo_matrix((vals, (u, c)), shape=(nnz, n)).tocsr()

    def operator(op):
        return scipy.sparse.coo_matrix((op.vals, (op.rows, op.cols)), shape=op.shape).tocsr()

    P = (
        entries(-lap.vals, u_lap, lap.cols)
        + entries(-gx.vals, u_gx, gx.rows) @ operator(gx)
        + entries(-gy.vals, u_gy, gy.rows) @ operator(gy)
    ).tocoo()
    return keys // n, keys % n, P


def _boundary_kernel(sites, boundary_points, dtype, torch_device, block: int = 2048):
    """The transport boundary's effective field as a matrix: ``Kb`` with
    ``ha = Kb @ g[boundary]`` equal to
    :func:`ops.kernels.boundary_effective_field` of the mid-segment
    streams ``0.5 (g_j + g_{j+1})`` (``adjoint.py:222-229``)."""
    centers = 0.5 * (boundary_points + np.roll(boundary_points, -1, axis=0))
    lengths, normals = path_vectors(close_curve(boundary_points))
    as_t = dict(dtype=dtype, device=torch_device)
    sites, centers = torch.as_tensor(sites, **as_t), torch.as_tensor(centers, **as_t)
    lengths, normals = torch.as_tensor(lengths, **as_t), torch.as_tensor(normals, **as_t)
    K = torch.empty((sites.shape[0], centers.shape[0]), **as_t)
    for lo in range(0, sites.shape[0], block):
        dr = sites[lo : lo + block, None, :] - centers[None, :, :]
        rinv = torch.rsqrt(torch.sum(dr * dr, dim=-1))
        dot = -torch.sum(dr * normals[None, :, :], dim=-1)
        K[lo : lo + block] = _ONE_OVER_4PI * lengths[None, :] * dot * (rinv * rinv * rinv)
    return 0.5 * (K + torch.roll(K, 1, dims=1))


@dataclass
class _FilmState:
    """One film's Lambda-dependent state within a forward call: the values
    of ``A``'s Lambda terms (in the graph), the factorized systems, and the
    parts of the solve that no coupling round changes."""

    vals: torch.Tensor
    main: FactoredSystem
    g_fixed: torch.Tensor  # (1, n) hole and transport streams
    h_fixed: torch.Tensor  # (1, n) their effective field (minus the transport's)
    vortex: Optional[torch.Tensor]  # (1, n) vortex response, or None


@dataclass
class AdjointModel:
    """A device compiled into a differentiable forward model.

    Build with :func:`build_adjoint_model`; ``model.forward_fn()`` returns
    a function of the parameter dict whose outputs ``torch.autograd``
    differentiates, and ``model.default_params()`` gives a template filled
    with the device's own Lambda profile and zero drives.
    """

    films: Dict[str, FilmAdjointData]
    film_order: Tuple[str, ...]
    hole_to_film: Dict[str, str]
    field_conversion: float
    vortex_flux: float
    field_units: str
    current_units: str
    length_units: str
    dtype: torch.dtype
    torch_device: torch.device
    vortices: Sequence[Vortex] = field(default_factory=tuple)

    def _tensor(self, value) -> torch.Tensor:
        if torch.is_tensor(value):
            return value.to(dtype=self.dtype, device=self.torch_device)
        return torch.as_tensor(np.asarray(value), dtype=self.dtype, device=self.torch_device)

    def default_params(self, applied_field=None) -> Dict:
        """Parameter-dict template.

        Args:
            applied_field: Optional field source (e.g.
                :class:`superscreen_tpu_torch.sources.ConstantField`)
                sampled at each film's sites (in ``field_units``) to fill
                ``params["applied_field"]``; zeros if omitted.

        Returns:
            ``{"Lambda": {film: (n,)}, "applied_field": {film: (n,)},
            "circulating_currents": {hole: ()},
            "vortex_nPhi0": {film: (n_vortices,)},
            "terminal_currents": {film: (n_terminals,)}}`` of tensors on
            the model's device (the last only for films with transport
            terminals, ordered like ``device.terminals[film]``; they must
            sum to zero).
        """
        params = {
            "Lambda": {},
            "applied_field": {},
            "circulating_currents": {},
            "vortex_nPhi0": {},
            "terminal_currents": {},
        }
        for name in self.film_order:
            data = self.films[name]
            params["Lambda"][name] = data.default_Lambda.clone()
            if applied_field is None:
                hz = np.zeros(data.n)
            else:
                sites = data.sites.cpu().numpy()
                # z as a per-site array, the convention every field source
                # is written against; a copy, since the broadcast is a
                # read-only view.
                hz = np.array(np.broadcast_to(
                    np.asarray(applied_field(sites[:, 0], sites[:, 1], np.full(data.n, data.z0))),
                    (data.n,),
                ))
            params["applied_field"][name] = self._tensor(hz)
            for hole in data.hole_names:
                params["circulating_currents"][hole] = self._tensor(0.0)
            if data.vortex_rows:
                params["vortex_nPhi0"][name] = self._tensor(
                    [v.nPhi0 for v in self.vortices if v.film == name]
                )
            if data.terminal_names:
                params["terminal_currents"][name] = self._tensor(np.zeros(len(data.terminal_names)))
        return params

    def _terminal_stream(self, data: FilmAdjointData, vals, main, fwb, terminal_currents):
        """The transport bootstrap (``adjoint.py:153-179``): the boundary
        stream from the per-terminal unit streams, centred; a solve in the
        film without its boundary; each hole set to its weighted average;
        a re-solve without the holes.  Returns ``(1, n)``."""
        w = data.weights
        g = torch.sum(terminal_currents[:, None] * data.term_unit_streams, dim=0, keepdim=True)
        # amax/amin split the gradient evenly among tied sites, as JAX's
        # max/min do; the unit streams are flat between terminals.
        gmax, gmin = torch.amax(g), torch.amin(g)
        g = g - gmax + (gmax - gmin) / 2
        ha = -data.A_apply(vals, g * data.boundary_mask)
        fwb_mask = (data.fwb_block or data.interior_block).mask
        g = g * (1 - fwb_mask) + BrandtSolve.apply(-ha, vals, fwb, data.lambda_pattern)
        if not data.hole_names:
            return g
        for m in data.hole_masks:
            avg = torch.sum(w * m * g) / torch.sum(w * m)
            g = g * (1 - m) + avg * m
        hole_support = torch.sum(data.hole_masks, dim=0)
        ha = -data.A_apply(vals, g * hole_support) - data.A_apply(vals, g * data.boundary_mask)
        solved = BrandtSolve.apply(-ha, vals, main, data.lambda_pattern)
        return g * (1 - data.interior_block.mask) + solved

    def _film_state(self, name: str, params: Dict) -> _FilmState:
        data = self.films[name]
        n = data.n
        Lambda = torch.broadcast_to(self._tensor(params["Lambda"][name]), (n,))
        # In float64 whatever the model's dtype: the (grad Lambda) . grad
        # values cancel to nothing for a uniform Lambda, and float32 sums of
        # them leave noise of the size of the Laplacian's rounding in A.
        vals = data.lambda_map(Lambda.double()).to(self.dtype)
        with torch.no_grad():
            main = data.interior_block.factor(data.Qw, vals.detach())
            fwb = (
                data.fwb_block.factor(data.Qw, vals.detach())
                if data.fwb_block is not None
                else main
            )
        zeros = torch.zeros((1, n), dtype=self.dtype, device=self.torch_device)
        g_fixed = h_fixed = zeros
        if data.hole_names:
            holes = torch.stack(
                [self._tensor(params["circulating_currents"][h]) for h in data.hole_names]
            )
            g_fixed = torch.sum(holes[:, None] * data.hole_masks, dim=0, keepdim=True)
            h_fixed = data.A_apply(vals, g_fixed)
        if data.terminal_names:
            terms = self._tensor(params["terminal_currents"][name])
            g_t = self._terminal_stream(data, vals, main, fwb, terms)
            boundary_stream = g_t[:, data.boundary_index]
            h_fixed = h_fixed - DenseProduct.apply(boundary_stream, data.boundary_kernel)
            g_fixed = g_fixed + g_t
        vortex = None
        if data.vortex_rows:
            # Brandt Eq. 28: response columns -(-A)^-1 e_j, scaled by
            # vortex_flux * nPhi0 / w_j (adjoint.py:241-245).
            columns = BrandtSolve.apply(data.vortex_rhs, vals, main, data.lambda_pattern)
            nphi0 = self._tensor(params["vortex_nPhi0"][name])
            scales = self.vortex_flux * nphi0 / data.weights[list(data.vortex_sites)]
            vortex = torch.sum(scales[:, None] * columns, dim=0, keepdim=True)
        return _FilmState(vals=vals, main=main, g_fixed=g_fixed, h_fixed=h_fixed, vortex=vortex)

    def _film_round(self, data: FilmAdjointData, state: _FilmState, hz, field_other):
        """One round of a film: the interior solve for the round's field,
        the stream, the sheet current and the screening field."""
        rhs = hz + field_other + state.h_fixed
        g = state.g_fixed + BrandtSolve.apply(rhs, state.vals, state.main, data.lambda_pattern)
        if state.vortex is not None:
            g = g - state.vortex
        J = torch.stack([data.gradient_y(g), -data.gradient_x(g)], dim=-1)
        if data.terminal_names:
            # With a nonzero boundary stream the Q diagonal regularization
            # is invalid; the triangle-centroid Biot-Savart replaces it.
            J_tri = torch.stack([data.gradient_tri_y(g), -data.gradient_tri_x(g)], dim=-1)
            screening = BiotSavartCoupling.apply(
                J_tri, data.tri_centroids, data.tri_areas, data.sites, 0.0
            )
        else:
            screening = DenseProduct.apply(g, data.Qw)
        return g, J, screening

    def forward_fn(self, iterations: int = 0) -> Callable[[Dict], Dict]:
        """A function ``params -> {film: fields}``.

        It runs the per-film solve plus ``iterations`` rounds of inter-film
        Biot-Savart coupling (one ``biot_savart_batch`` pass per ordered
        film pair and round).  Outputs per film: ``stream`` (current
        units), ``current_density`` (current / length units),
        ``self_field`` and ``field_from_other_films`` (``field_units``),
        as the corresponding :class:`superscreen_tpu_torch.FilmSolution`
        attributes; with ``applied_field[film]`` of shape ``(B, n)`` each
        gets a leading ``B``.  ``torch.autograd`` differentiates them with
        respect to every tensor of ``params`` that requires grad.
        """
        films, order, conv = self.films, self.film_order, self.field_conversion

        def forward(params: Dict) -> Dict:
            with highest_matmul_precision():
                applied = {name: self._tensor(params["applied_field"][name]) for name in order}
                batched = any(hz.ndim == 2 for hz in applied.values())
                hz = {name: (a if a.ndim == 2 else a[None]) * conv for name, a in applied.items()}
                B = max(h.shape[0] for h in hz.values())
                states = {name: self._film_state(name, params) for name in order}
                def zeros(name):
                    return torch.zeros((1, films[name].n), dtype=self.dtype, device=self.torch_device)

                others = {name: zeros(name) for name in order}

                def run_round():
                    return {
                        name: self._film_round(films[name], states[name], hz[name], others[name])
                        for name in order
                    }

                fields = run_round()
                for _ in range(iterations):
                    others = {}
                    for target in order:
                        dst = films[target]
                        total = zeros(target)
                        for source in order:
                            if source == target:
                                continue
                            src = films[source]
                            total = total + BiotSavartCoupling.apply(
                                fields[source][1], src.sites, src.weights, dst.sites,
                                float((dst.z0 - src.z0) ** 2),
                            )
                        others[target] = total
                    fields = run_round()
                out = {}
                for name in order:
                    g, J, screening = fields[name]
                    n = films[name].n
                    result = {
                        "stream": g.expand(B, n),
                        "current_density": J.expand(B, n, 2),
                        "self_field": (screening / conv).expand(B, n),
                        "field_from_other_films": (others[name] / conv).expand(B, n),
                    }
                    out[name] = result if batched else {k: v[0] for k, v in result.items()}
                return out

        return forward


def build_adjoint_model(
    device: Device,
    *,
    vortices: Optional[Sequence[Vortex]] = None,
    field_units: str = "mT",
    current_units: str = "mA",
    dtype=None,
    torch_device="cuda",
) -> AdjointModel:
    """Compiles a meshed :class:`Device` into an :class:`AdjointModel`
    whose forward solve ``torch.autograd`` differentiates.

    Args:
        device: The device (must be meshed).  Films with transport
            terminals get a ``params["terminal_currents"][film]`` vector
            (ordered like ``device.terminals[film]``, must sum to zero).
        vortices: Pinned vortices.  Their positions snap to mesh sites at
            build time (a discrete choice, so positions are not
            differentiable); their ``nPhi0`` values become parameters.
        field_units: Units of ``params["applied_field"]`` and the returned
            fields.
        current_units: Units of circulating currents and streams.
        dtype: Tensor dtype (defaults to ``device.solve_dtype``; float64
            for gradient work that a finite difference must match).
        torch_device: ``"cuda"`` (default; raises without a card) or
            ``"cpu"`` (the plain PyTorch kernels).

    Returns:
        The :class:`AdjointModel`.
    """
    torch_device = resolve_torch_device(torch_device)
    if not device.meshes:
        raise ValueError(
            "The device does not have a mesh. Call device.make_mesh() to generate it."
        )
    vortices = tuple(vortices or ())
    np_dtype = np.dtype(dtype if dtype is not None else device.solve_dtype)
    tdtype = torch_dtype(np_dtype)
    as_t = dict(dtype=tdtype, device=torch_device)
    film_info = make_film_info(
        device=device,
        vortices=list(vortices),
        circulating_currents={},
        terminal_currents={},
        torch_device=torch_device,
        dtype=np_dtype,
        operators=False,
    )
    films: Dict[str, FilmAdjointData] = {}
    hole_to_film: Dict[str, str] = {}
    for name, info in film_info.items():
        mesh = device.meshes[name]
        ops = mesh.operators
        n = len(mesh.sites)
        ix = info.interior_indices
        if info.hole_indices:
            ix = np.setdiff1d(ix, np.concatenate(list(info.hole_indices.values())))
        hole_names = tuple(info.hole_indices)
        for hole in hole_names:
            hole_to_film[hole] = name
        hole_masks = np.zeros((len(hole_names), n))
        for k, hole in enumerate(hole_names):
            hole_masks[k, info.hole_indices[hole]] = 1.0
        # Vortex sites snap to the nearest mesh site (the rule of
        # solve_film); rows index into the interior system.
        vortex_rows, vortex_sites = [], []
        for v in info.vortices:
            vortex_rows.append(int(np.argmin(np.linalg.norm(mesh.sites[ix] - (v.x, v.y), axis=1))))
            vortex_sites.append(int(np.argmin(np.linalg.norm(mesh.sites - (v.x, v.y), axis=1))))
        vortex_rhs = None
        if vortex_rows:
            vortex_rhs = torch.zeros((len(vortex_rows), n), **as_t)
            vortex_rhs[torch.arange(len(vortex_rows)), torch.as_tensor(ix[vortex_rows])] = 1.0
        sites = torch.as_tensor(mesh.sites, **as_t)
        weights = torch.as_tensor(ops.weights, **as_t)
        rows, cols, P = _lambda_operators(ops, n)
        lambda_pattern = SparsePattern.from_coo(rows, cols, (n, n), torch_device)

        def block(index):
            return SystemBlock.build(index, rows, cols, n, tdtype, torch_device)

        def operator(op):
            return SparseOperator.from_coo(op.rows, op.cols, op.vals, op.shape, tdtype, torch_device)

        terminal_kwargs = {}
        if name in device.terminals:
            b_ix = np.asarray(info.boundary_indices, dtype=np.int64)
            # Per-terminal unit streams through the solver's own boundary
            # walk (the bootstrap is linear in the terminal currents).
            terminals = device.terminals[name]
            unit_streams = np.stack(
                [boundary_stream_from_indices(device, name, b_ix, {t.name: 1.0}) for t in terminals]
            )
            fwb = np.asarray(info.interior_indices, dtype=np.int64)
            boundary_mask = np.zeros(n)
            boundary_mask[b_ix] = 1.0
            terminal_kwargs = dict(
                terminal_names=tuple(t.name for t in terminals),
                fwb_block=block(fwb) if hole_names else None,
                boundary_index=torch.as_tensor(b_ix, device=torch_device),
                boundary_mask=torch.as_tensor(boundary_mask, **as_t),
                term_unit_streams=torch.as_tensor(unit_streams, **as_t),
                boundary_kernel=_boundary_kernel(mesh.sites, mesh.sites[b_ix], tdtype, torch_device),
                tri_centroids=torch.as_tensor(mesh.triangle_centroids, **as_t),
                tri_areas=torch.as_tensor(mesh.triangle_areas, **as_t),
                gradient_tri_x=operator(ops.gradient_tri_x),
                gradient_tri_y=operator(ops.gradient_tri_y),
            )
        films[name] = FilmAdjointData(
            name=name,
            n=n,
            hole_names=hole_names,
            vortex_rows=tuple(vortex_rows),
            vortex_sites=tuple(vortex_sites),
            sites=sites,
            weights=weights,
            Qw=kernels.Q_matrix(sites, weights).mul_(weights[None, :]),
            lambda_pattern=lambda_pattern,
            lambda_map=SparseOperator.from_coo(
                P.row, P.col, P.data, P.shape, torch.float64, torch_device
            ),
            gradient_x=operator(ops.gradient_x),
            gradient_y=operator(ops.gradient_y),
            interior=np.asarray(ix, dtype=np.int64),
            interior_block=block(ix),
            hole_masks=torch.as_tensor(hole_masks, **as_t),
            z0=float(device.layers[info.layer].z0),
            default_Lambda=torch.as_tensor(np.asarray(info.lambda_info.Lambda)[:, 0], **as_t),
            vortex_rhs=vortex_rhs,
            **terminal_kwargs,
        )
    ureg = device.ureg
    field_conversion = field_conversion_factor(
        field_units, current_units, length_units=device.length_units, ureg=ureg
    ).magnitude
    return AdjointModel(
        films=films,
        film_order=tuple(device.films),
        hole_to_film=hole_to_film,
        field_conversion=float(field_conversion),
        vortex_flux=float(vortex_flux_quantum(device, current_units)),
        field_units=field_units,
        current_units=current_units,
        length_units=device.length_units,
        dtype=tdtype,
        torch_device=torch_device,
        vortices=vortices,
    )
