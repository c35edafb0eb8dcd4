"""Plain reference of a transport stack: films whose penetration depth
varies over the film, a film driven by a current between two terminals,
vortices trapped in a film, and the films coupled as in
:func:`benchmark.reference.films.coupled_streams`.  Written from upstream
SuperScreen's published method (its ``solver/solve_film.py``,
``solver/utils.py`` and ``device/device.py``; SURVEY.md section 1), in
NumPy and plain PyTorch; nothing of the measured program is imported.

**A position-dependent Lambda.**  Lambda is evaluated at every site from the
configuration's Gaussian weak spot, and the film's operator is
``A = Q diag(w) - L diag(Lambda) - (grad Lambda) . grad``: upstream's
``Lambda[ix, 0] * laplacian[ix, ix]`` scales column ``j`` of the Laplacian
by ``Lambda_j`` (the two orders agree for a uniform Lambda), and the last
term is ``diag(gx Lambda) gx + diag(gy Lambda) gy`` with the vertex
gradients (upstream ``solve_film.py:183``).

**The terminal drive**, run anew for every drive (upstream
``solve_film.py:308-390``, ``utils.py:440-488``):

1. Walk the film's outer boundary counterclockwise (upstream
   ``device.py:473-500``).  The walk starts on the vertex after a
   terminal, so that no terminal straddles its start, as upstream's roll
   ensures.  Each terminal's current ``I`` enters uniformly across it: along
   its vertices the stream ramps from 0 to ``-I`` by the cumulative
   trapezoid of the terminal's edge lengths (``stream_from_terminal_current``,
   normalised to end at ``-I``); every vertex of the terminal but its last
   takes the ramp's values, and from its last vertex on, the rest of the
   walk takes ``-I`` (upstream ``solve_film.py:337-345``).  The currents
   sum to zero, so the walk ends where it began, and after the centring
   the boundary's values do not depend on where the walk starts.
2. Centre it: ``g - max(g) + ptp(g) / 2`` over all sites, the interior's
   zeros included (upstream ``solve_film.py:348``); the solves below
   overwrite every value off the boundary.
3. Solve the film with the boundary fixed: the interior, holes included,
   satisfies ``A g = 0`` on its rows.
4. Pin each hole to its area-weighted mean, and solve the film outside its
   holes again with the boundary and the holes fixed.

The film is then solved as any film, with this stream ``g_tr`` added to
its fixed values and the field of the boundary stream, a line of dipoles
along the edge (upstream ``_get_boundary_effective_field``,
``solve_film.py:393-412``), taken from the applied field: the interior
stream is ``g_tr`` plus the solution of ``(-A) x = H_z - H_holes - H_tr``.

**Vortices** (Brandt, PRB 72, 024529, Eq. 28): a vortex of ``n`` flux
quanta at ``r_v`` adds ``n Phi_0 / (mu_0 w_j) A^-1 e_k`` to the interior
stream, where ``j`` is the site nearest ``r_v`` and ``k`` the interior site
nearest it.

**A terminal film's self-field** is the in-film Biot-Savart sum over its
triangles (upstream ``_biot_savart_within_film``,
``solve_film.py:415-437``): each triangle's current density, the gradient
of the stream's linear interpolant rotated, sits at its centroid with its
area.

The precisions are :mod:`films`'s: ``F64``, and ``TF32`` for the control.
"""

from typing import Dict, List

import numpy as np
import torch

from .config import FIELD_PER_MT, MU_0, PHI_0, load_mesh
from .config import film_meshes as base_film_meshes
from .films import BLOCK, FOUR_PI, REFINE_STEPS, FilmSystem, Precision, coupled_streams, q_block, spmm
from .mesh import closed_ccw, points_in_ring, triangle_areas

#: Currents and lengths of a configuration, in amperes and metres.
CURRENT_UNITS = {"uA": 1e-6, "mA": 1e-3, "A": 1.0}
LENGTH_UNITS = {"um": 1e-6, "nm": 1e-9}


def lambda_at(sites: np.ndarray, layer: dict) -> np.ndarray:
    """The layer's Lambda at ``sites``: its base ``Lambda`` times
    ``1 + depth exp(-|r - r0|^2 / (2 sigma^2))`` of its ``weak_spot``."""
    spot = layer.get("weak_spot")
    if spot is None:
        return np.full(len(sites), float(layer["Lambda"]))
    r2 = (sites[:, 0] - spot["x0"]) ** 2 + (sites[:, 1] - spot["y0"]) ** 2
    return float(layer["Lambda"]) * (1 + spot["depth"] * np.exp(-r2 / (2 * spot["sigma"] ** 2)))


def triangle_gradients(sites: np.ndarray, elements: np.ndarray):
    """``(gx, gy)``, each ``(m, 3)``: the gradient on each triangle of the
    hat function of each of its vertices (the opposite edge turned by -90
    degrees over twice the signed area)."""
    p = sites[elements]
    edges = np.roll(p, 2, axis=1) - np.roll(p, 1, axis=1)
    area2 = 2 * triangle_areas(sites, elements)[:, None]
    return edges[:, :, 1] / area2, -edges[:, :, 0] / area2


def boundary_walk(sites: np.ndarray, elements: np.ndarray, terminals: Dict[str, np.ndarray]) -> np.ndarray:
    """The vertices of the mesh's outer boundary, counterclockwise, starting
    on the vertex after the last vertex of a terminal (a polygon's vertices
    as ``terminals``' values; with none, anywhere)."""
    tri = np.asarray(elements, dtype=np.int64).copy()
    cw = triangle_areas(sites, tri) < 0
    tri[cw] = tri[cw][:, ::-1]
    # A boundary edge belongs to one triangle; in a counterclockwise
    # triangle it runs counterclockwise around the outer boundary.
    directed = np.concatenate([tri[:, [0, 1]], tri[:, [1, 2]], tri[:, [2, 0]]])
    undirected = np.sort(directed, axis=1)
    _, inverse, counts = np.unique(undirected, axis=0, return_inverse=True, return_counts=True)
    edges = directed[counts[inverse.ravel()] == 1]
    succ = dict(zip(edges[:, 0].tolist(), edges[:, 1].tolist()))
    loops, seen = [], set()
    for start in succ:
        if start in seen:
            continue
        loop, v = [], start
        while v not in seen:
            seen.add(v)
            loop.append(v)
            v = succ[v]
        loops.append(np.asarray(loop))

    def area(loop):
        x, y = sites[loop, 0], sites[loop, 1]
        return 0.5 * np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y)

    walk = max(loops, key=area)
    if not terminals:
        return walk
    inside = points_in_ring(closed_ccw(next(iter(terminals.values()))), sites[walk])
    # The first vertex outside the terminal that follows one inside it.
    after = np.flatnonzero(~inside & np.roll(inside, 1))
    return np.roll(walk, -int(after[0]))


def terminal_ramp(points: np.ndarray, current: float) -> np.ndarray:
    """The stream along a terminal's vertices ``points`` (in walk order)
    carrying ``current`` uniformly across it: ``len(points) - 1`` values
    from 0 to ``current``, the cumulative trapezoid of the edge lengths
    (upstream ``stream_from_current_density`` with the uniform current of
    ``stream_from_terminal_current``) normalised to end at ``current``."""
    lengths = np.linalg.norm(np.diff(points, axis=0), axis=1)
    G = np.concatenate([[0.0], np.cumsum(0.5 * (lengths[1:] + lengths[:-1]))])
    return current * G / G[-1]


class TransportFilm(FilmSystem):
    """One film with Lambda at each site ``lam`` (host, float64), its
    terminals ``{name: polygon vertices}`` and its vortices ``[(x, y)]``."""

    def __init__(self, film, elements, lam, terminals, vortices, flux_quantum, prec: Precision, device):
        self.lam = torch.as_tensor(lam, dtype=prec.dtype, device=device)
        self.elements = np.asarray(elements, dtype=np.int64)
        self.terminals = dict(terminals)
        super().__init__(film, prec, device)
        dt = prec.dtype
        ni = len(film.interior)
        # The drive of the next sweep: fixed stream, the field it applies,
        # and the vortices' interior stream, ``(n, B)``, ``(n, B)`` and
        # ``(ni, B)``; none until :meth:`set_drive`.
        self.g_tr = self.h_tr = self.g_vortex = self.vortex_cols = None
        if vortices:
            sites = film.sites
            inner = film.interior
            cols = torch.zeros((ni, len(vortices)), dtype=dt, device=device)
            self.vortex_scale = torch.zeros(len(vortices), dtype=dt, device=device)
            for k, (x, y) in enumerate(vortices):
                d = np.hypot(sites[:, 0] - x, sites[:, 1] - y)
                cols[int(np.argmin(d[inner])), k] = 1.0
                self.vortex_scale[k] = flux_quantum / film.areas[int(np.argmin(d))]
            # A^-1 e_k: the factors are of -A.
            self.vortex_cols = -self._refined(self.lu, self.piv, self.A, cols)
        if self.terminals:
            self.walk = boundary_walk(film.sites, self.elements, self.terminals)
            # The film without its boundary, holes included, and its system.
            self.unpinned = np.union1d(film.interior, np.concatenate([np.zeros(0, np.int64), *film.holes.values()]))
            self.A_unpinned = self.system(self.unpinned)
            self.lu_unpinned, self.piv_unpinned = torch.linalg.lu_factor(-self.A_unpinned)
            # The edge's dipoles: segment centres, outward normals, lengths.
            b = film.sites[self.walk]
            seg = np.roll(b, -1, axis=0) - b
            lengths = np.linalg.norm(seg, axis=1)
            self.edge_centres = torch.as_tensor(b + 0.5 * seg, dtype=dt, device=device)
            self.edge_normals = torch.as_tensor(seg[:, ::-1] * [1.0, -1.0] / lengths[:, None], dtype=dt, device=device)
            self.edge_lengths = torch.as_tensor(lengths, dtype=dt, device=device)
            # Triangle centroids, areas and gradients, for the self-field.
            self.tri_centroids = torch.as_tensor(film.sites[self.elements].mean(axis=1), dtype=dt, device=device)
            self.tri_areas = torch.as_tensor(np.abs(triangle_areas(film.sites, self.elements)), dtype=dt, device=device)
            self.tri_gx, self.tri_gy = (
                torch.as_tensor(a, dtype=dt, device=device) for a in triangle_gradients(film.sites, self.elements)
            )

    # -- the operator ------------------------------------------------------

    def _grad_lambda(self):
        lam = self.lam[:, None]
        return spmm(self.gx, lam)[:, 0], spmm(self.gy, lam)[:, 0]

    def system(self, ix: np.ndarray) -> torch.Tensor:
        """``A`` restricted to the rows and columns ``ix``."""
        ix = torch.as_tensor(ix, device=self.sites.device)
        sub = self.sites[ix]
        ni = len(ix)
        A = torch.empty((ni, ni), dtype=self.prec.dtype, device=sub.device)
        for lo in range(0, ni, BLOCK):
            A[lo:lo + BLOCK] = -q_block(sub[lo:lo + BLOCK], sub)
        A.diagonal().copy_(self.cw[ix] / self.w[ix])
        A.mul_(self.w[ix][None, :])
        pos = torch.full((self.n,), -1, dtype=torch.long, device=sub.device)
        pos[ix] = torch.arange(ni, device=sub.device)
        glx, gly = self._grad_lambda()
        for (rows, cols, vals, _), scale in (
            (self.lap, lambda r, c: self.lam[c]), (self.gx, lambda r, c: glx[r]), (self.gy, lambda r, c: gly[r]),
        ):
            keep = (pos[rows] >= 0) & (pos[cols] >= 0)
            r, c = rows[keep], cols[keep]
            A.index_put_((pos[r], pos[c]), -vals[keep] * scale(r, c), accumulate=True)
        return A

    def _interior_system(self) -> torch.Tensor:
        return self.system(self.film.interior)

    def kernel_apply(self, V: torch.Tensor) -> torch.Tensor:
        """``A V`` over all sites, ``V`` ``(n, k)``."""
        wV = self.w[:, None] * V
        out = self.cw[:, None] * V
        for lo in range(0, self.n, BLOCK):
            out[lo:lo + BLOCK] -= self.prec.mm(q_block(self.sites[lo:lo + BLOCK], self.sites), wV)
        glx, gly = self._grad_lambda()
        return (
            out - spmm(self.lap, self.lam[:, None] * V)
            - glx[:, None] * spmm(self.gx, V) - gly[:, None] * spmm(self.gy, V)
        )

    def _refined(self, lu, piv, A, h):
        """``x`` with ``(-A) x = h``, refined as :meth:`FilmSystem.solve`."""
        x = torch.linalg.lu_solve(lu, piv, h)
        for _ in range(REFINE_STEPS):
            x = x + torch.linalg.lu_solve(lu, piv, h + self.prec.mm(A, x))
        return x

    # -- the drive ----------------------------------------------------------

    def boundary_stream(self, currents: Dict[str, float]) -> np.ndarray:
        """Steps 1 and 2 for one drive ``{terminal: current}``: ``(n,)``,
        zero off the boundary."""
        sites = self.film.sites
        along = np.zeros(len(self.walk))
        for name, ring in self.terminals.items():
            current = float(currents.get(name, 0.0))
            on = np.flatnonzero(points_in_ring(closed_ccw(ring), sites[self.walk]))
            if current == 0.0:
                continue
            ramp = terminal_ramp(sites[self.walk[on]], -current)
            along[on[:-1]] += ramp
            along[on[-1]:] += ramp[-1]
        g = np.zeros(self.n)
        g[self.walk] = along
        if not np.any(along):
            return g
        return g - g.max() + np.ptp(g) / 2

    def transport_streams(self, drives: List[Dict[str, float]]) -> torch.Tensor:
        """Steps 1-4 for each drive: ``g_tr`` ``(n, B)``."""
        dt, device = self.prec.dtype, self.sites.device
        g = torch.as_tensor(np.stack([self.boundary_stream(d) for d in drives], axis=1), dtype=dt, device=device)
        walk = torch.as_tensor(self.walk, device=device)
        fixed = torch.zeros_like(g)
        fixed[walk] = g[walk]
        unpinned = torch.as_tensor(self.unpinned, device=device)
        g[unpinned] = self._refined(self.lu_unpinned, self.piv_unpinned, self.A_unpinned, self.kernel_apply(fixed)[unpinned])
        if not self.hole_names:
            return g
        for k in range(len(self.hole_names)):
            mask = self.hole_masks[k].bool()
            mean = (self.w[mask, None] * g[mask]).sum(dim=0) / self.w[mask].sum()
            g[mask] = mean[None, :]
            fixed[mask] = mean[None, :]
        g[self.interior] = self._refined(self.lu, self.piv, self.A, self.kernel_apply(fixed)[self.interior])
        return g

    def edge_field(self, g: torch.Tensor) -> torch.Tensor:
        """The field ``(n, B)`` of the boundary stream of ``g``: a dipole per
        boundary segment, of strength the segment's mean stream times its
        length, along its outward normal."""
        walk = torch.as_tensor(self.walk, device=g.device)
        gb = g[walk]
        strength = self.edge_lengths[:, None] * 0.5 * (gb + torch.roll(gb, -1, dims=0))
        out = torch.empty_like(g)
        for lo in range(0, self.n, BLOCK):
            dr = self.sites[lo:lo + BLOCK, None, :] - self.edge_centres[None, :, :]
            r2 = torch.sum(dr * dr, dim=-1)
            dipole = -torch.sum(dr * self.edge_normals[None, :, :], dim=-1) * r2 ** -1.5
            out[lo:lo + BLOCK] = self.prec.mm(dipole, strength)
        return out / FOUR_PI

    def set_drive(self, terminal_currents: List[Dict[str, float]], vortex_nPhi0) -> None:
        """The drive of each of the next sweep's ``B`` points: terminal
        currents and vortex amplitudes ``(B, n_vortices)``."""
        B = len(terminal_currents)
        zeros = torch.zeros((self.n, B), dtype=self.prec.dtype, device=self.sites.device)
        self.g_tr, self.h_tr = zeros, zeros
        if self.terminals:
            self.g_tr = self.transport_streams(terminal_currents)
            self.h_tr = self.edge_field(self.g_tr)
        self.g_vortex = None
        if self.vortex_cols is not None:
            amps = torch.as_tensor(np.asarray(vortex_nPhi0, dtype=float).T, dtype=self.prec.dtype, device=self.sites.device)
            self.g_vortex = self.vortex_cols @ (self.vortex_scale[:, None] * amps)

    def solve(self, Hz: torch.Tensor, I: torch.Tensor) -> torch.Tensor:
        """The stream ``(n, B)`` under ``Hz`` with hole currents ``I`` and the
        drive of :meth:`set_drive`."""
        g0 = self.g_tr + (self.hole_masks.T @ I if self.hole_names else 0)
        H = Hz - self.h_tr - (self.hole_fields.T @ I if self.hole_names else 0)
        x = self._refined(self.lu, self.piv, self.A, H[self.interior])
        if self.g_vortex is not None:
            x = x + self.g_vortex
        return g0.index_add(0, self.interior, x)

    def self_field(self, g: torch.Tensor) -> torch.Tensor:
        """The in-film Biot-Savart field ``(n, B)`` of a terminal film's
        stream ``g`` ``(n, B)``."""
        el = torch.as_tensor(self.elements, device=g.device)
        gt = g[el]  # (m, 3, B)
        Jx = torch.einsum("tk,tkb->tb", self.tri_gy, gt) * self.tri_areas[:, None]
        Jy = -torch.einsum("tk,tkb->tb", self.tri_gx, gt) * self.tri_areas[:, None]
        out = torch.empty_like(g)
        for lo in range(0, self.n, BLOCK):
            rows = self.sites[lo:lo + BLOCK]
            dx = rows[:, None, 0] - self.tri_centroids[None, :, 0]
            dy = rows[:, None, 1] - self.tri_centroids[None, :, 1]
            r3 = (dx * dx + dy * dy) ** -1.5
            out[lo:lo + BLOCK] = self.prec.mm(dy * r3, Jx) - self.prec.mm(dx * r3, Jy)
        return out / FOUR_PI


class TransportStack:
    """The films of a transport configuration's ``stack``, factorized on
    ``device`` in ``prec``; :meth:`sweep` recomputes one call."""

    def __init__(self, config: dict, prec: Precision, device="cpu"):
        # Float32 products in float32 (the control rounds its operands to
        # TF32 itself, :func:`films.tf32`).
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.config, self.prec, self.device = config, prec, device
        spec = config["devices"]["stack"]
        layers = {l["name"]: l for l in spec["layers"]}
        units = CURRENT_UNITS[config["current_units"]] * LENGTH_UNITS[spec["length_units"]]
        flux_quantum = PHI_0 / MU_0 / units
        self.films: List[TransportFilm] = []
        for film, f in zip(base_film_meshes(spec), spec["films"]):
            _, elements = load_mesh(spec["files"][f["name"]])
            terminals = {t["name"]: np.asarray(t["points"], dtype=float) for t in f.get("terminals", [])}
            vortices = [(v["x"], v["y"]) for v in config["vortices"] if v["film"] == f["name"]]
            lam = lambda_at(film.sites, layers[f["layer"]])
            self.films.append(TransportFilm(film, elements, lam, terminals, vortices, flux_quantum, prec, device))

    def sweep(self, params: dict) -> dict:
        """Every point of one call (the entry's ``params``): both films' last
        round's streams ``(B, n)`` and the terminal film's self-field
        ``(B, n)`` in the configuration's field units."""
        c = self.config
        bias = c["bias"]
        B = len(params["bias"])
        drives = [{bias["source"]: float(I), bias["drain"]: -float(I)} for I in params["bias"]]
        amps = np.asarray(params["vortex_nPhi0"], dtype=float)
        Hz, I = {}, {}
        start = 0
        for s in self.films:
            name = s.film.name
            n_v = 0 if s.vortex_cols is None else s.vortex_cols.shape[1]
            s.set_drive(drives if name == bias["film"] else [{}] * B, amps[:, start:start + n_v])
            start += n_v
            Hz[name] = torch.full((s.n, B), FIELD_PER_MT * params["field"], dtype=self.prec.dtype, device=self.device)
            I[name] = torch.zeros((len(s.hole_names), B), dtype=self.prec.dtype, device=self.device)
            for k, hole in enumerate(s.hole_names):
                if hole == c["swept_hole"]:
                    I[name][k] = torch.as_tensor(params["hole_current"], dtype=self.prec.dtype, device=self.device)
        g = coupled_streams(self.films, Hz, I, c["iterations"])
        strip = next(s for s in self.films if s.film.name == bias["film"])
        field = strip.self_field(g[bias["film"]]) / FIELD_PER_MT
        return {
            "streams": {name: v.double().cpu().numpy().T for name, v in g.items()},
            "self_field": field.double().cpu().numpy().T,
        }
