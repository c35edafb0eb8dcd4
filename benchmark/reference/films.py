"""Plain PyTorch reference of the thin-film screening solve (Brandt's
method) for stacks of films: each film's system, its solution for a batch
of drives, and the self-consistent Biot-Savart coupling between films.

For a film with sites ``r_i``, vertex areas ``w_i`` and penetration depth
``Lambda``, the stream function ``g`` on the interior solves
``(-A) g = H_z - H_holes`` with
``A = Q diag(w) - Lambda L``, ``Q_ij = -q_ij`` off the diagonal,
``Q_ii = (C_i + sum_l q_il w_l) / w_i``, ``q_ij = 1 / (4 pi |r_i - r_j|^3)``,
``C`` the boundary regularization of Brandt (PRB 72, 024529, Eq. 12) and
``L`` the Laplace-Beltrami operator.  Sites in a hole hold the hole's
circulating current ``I``; their effect on the interior is the field
``H_holes = -I (A_hole 1)``.  The sheet current is ``J = (dg/dy, -dg/dx)``
and a film at height ``z_a`` applies
``H_z = 1/(4 pi) sum_j w_j ((y - y_j) J_x - (x - x_j) J_y) / (rho^2 + dz^2)^(3/2)``
to the others.

Two precisions: ``"float64"`` (the reference) and ``"tf32"``, the
control: float32 storage with every matrix product taking its operands
rounded to TF32's 10-bit mantissa, as the card's TF32 tensor cores do.
"""

import math
from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from .mesh import FilmMesh

FOUR_PI = 4 * math.pi
#: Rows per block of a pairwise sum (bounds the temporaries).
BLOCK = 2048
#: Refinement steps of each film solve (a residual of the working
#: precision; in float64 they change nothing that a comparison sees).
REFINE_STEPS = 2


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to the nearest TF32 value (10 mantissa bits,
    ties to even)."""
    bits = x.contiguous().view(torch.int32)
    rounded = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return rounded.view(torch.float32)


@dataclass(frozen=True)
class Precision:
    """``name`` is ``"float64"`` or ``"tf32"``."""

    name: str

    @property
    def dtype(self) -> torch.dtype:
        return torch.float64 if self.name == "float64" else torch.float32

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.name == "tf32":
            return tf32(a) @ tf32(b)
        return a @ b


F64 = Precision("float64")
TF32 = Precision("tf32")


def q_block(rows: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``1 / (4 pi |r_i - r_j|^3)``, zero where the points coincide."""
    d2 = (rows[:, None, 0] - src[None, :, 0]) ** 2 + (rows[:, None, 1] - src[None, :, 1]) ** 2
    safe = torch.where(d2 > 0, d2, torch.ones_like(d2))
    return torch.where(d2 > 0, safe ** -1.5 / FOUR_PI, torch.zeros_like(d2))


def boundary_c(sites: torch.Tensor) -> torch.Tensor:
    """Brandt's boundary regularization ``C_i`` (infinite terms at 1e30)."""
    x = sites[:, 0] - sites[:, 0].mean()
    y = sites[:, 1] - sites[:, 1].mean()
    a = (x.max() - x.min()) / 2
    b = (y.max() - y.min()) / 2
    C = sum(torch.sqrt((a - p * x) ** -2 + (b - s * y) ** -2) for p in (-1, 1) for s in (-1, 1))
    return torch.where(torch.isfinite(C), C, torch.full_like(C, 1e30)) / FOUR_PI


def _sparse(t, n_rows: int, prec: Precision, device):
    return (
        torch.as_tensor(t.rows, device=device),
        torch.as_tensor(t.cols, device=device),
        torch.as_tensor(t.vals, dtype=prec.dtype, device=device),
        n_rows,
    )


def spmm(op, x: torch.Tensor) -> torch.Tensor:
    """Sparse triplets ``op`` times ``x`` of shape ``(n, k)``."""
    rows, cols, vals, n = op
    out = torch.zeros((n, x.shape[1]), dtype=x.dtype, device=x.device)
    return out.index_add_(0, rows, vals[:, None] * x[cols])


class FilmSystem:
    """One film's interior system, factorized, on ``device``."""

    def __init__(self, film: FilmMesh, prec: Precision, device):
        self.film, self.prec = film, prec
        dt = prec.dtype
        self.sites = torch.as_tensor(film.sites, dtype=dt, device=device)
        self.w = torch.as_tensor(film.areas, dtype=dt, device=device)
        self.n = len(film.sites)
        self.interior = torch.as_tensor(film.interior, device=device)
        self.lap = _sparse(film.lap, self.n, prec, device)
        self.gx = _sparse(film.gx, self.n, prec, device)
        self.gy = _sparse(film.gy, self.n, prec, device)
        # The kernel's diagonal times w: C + q @ w.
        qw = torch.empty(self.n, dtype=dt, device=device)
        for lo in range(0, self.n, BLOCK):
            qw[lo:lo + BLOCK] = prec.mm(q_block(self.sites[lo:lo + BLOCK], self.sites), self.w[:, None])[:, 0]
        self.cw = boundary_c(self.sites) + qw
        self.A = self._interior_system()
        self.lu, self.piv = torch.linalg.lu_factor(-self.A)
        # -(A_hole 1) for each hole: the field of a unit circulating current.
        self.hole_names = list(film.holes)
        self.hole_masks = torch.zeros((len(self.hole_names), self.n), dtype=dt, device=device)
        for k, name in enumerate(self.hole_names):
            self.hole_masks[k, torch.as_tensor(film.holes[name], device=device)] = 1.0
        self.hole_fields = -self.kernel_apply(self.hole_masks.T).T if self.hole_names else self.hole_masks

    def _interior_system(self) -> torch.Tensor:
        ix = self.interior
        sub = self.sites[ix]
        ni = len(ix)
        A = torch.empty((ni, ni), dtype=self.prec.dtype, device=sub.device)
        for lo in range(0, ni, BLOCK):
            A[lo:lo + BLOCK] = -q_block(sub[lo:lo + BLOCK], sub)
        A.diagonal().copy_(self.cw[ix] / self.w[ix])
        A.mul_(self.w[ix][None, :])
        pos = torch.full((self.n,), -1, dtype=torch.long, device=sub.device)
        pos[ix] = torch.arange(ni, device=sub.device)
        rows, cols, vals, _ = self.lap
        keep = (pos[rows] >= 0) & (pos[cols] >= 0)
        A.index_put_((pos[rows[keep]], pos[cols[keep]]), -self.film.Lambda * vals[keep], accumulate=True)
        return A

    def kernel_apply(self, V: torch.Tensor) -> torch.Tensor:
        """``(Q diag(w) - Lambda L) V`` over all sites, ``V`` ``(n, k)``."""
        wV = self.w[:, None] * V
        out = self.cw[:, None] * V
        for lo in range(0, self.n, BLOCK):
            out[lo:lo + BLOCK] -= self.prec.mm(q_block(self.sites[lo:lo + BLOCK], self.sites), wV)
        return out - self.film.Lambda * spmm(self.lap, V)

    def solve(self, Hz: torch.Tensor, I: torch.Tensor) -> torch.Tensor:
        """The stream ``(n, B)`` under the applied field ``Hz`` ``(n, B)``
        with circulating currents ``I`` ``(n_holes, B)``."""
        g0 = self.hole_masks.T @ I if self.hole_names else torch.zeros_like(Hz)
        H = Hz - (self.hole_fields.T @ I if self.hole_names else 0)
        h = H[self.interior]
        x = torch.linalg.lu_solve(self.lu, self.piv, h)
        for _ in range(REFINE_STEPS):
            r = h + self.prec.mm(self.A, x)
            x = x + torch.linalg.lu_solve(self.lu, self.piv, r)
        return g0.index_add(0, self.interior, x)

    def current(self, g: torch.Tensor):
        """``(J_x, J_y)``, each ``(n, B)``."""
        return spmm(self.gy, g), -spmm(self.gx, g)


def biot_savart(src: FilmSystem, Jx, Jy, dst_sites: torch.Tensor, dz2: float, prec: Precision) -> torch.Tensor:
    """``H_z`` ``(m, B)`` at ``dst_sites`` from the sheet current of ``src``."""
    aJx, aJy = src.w[:, None] * Jx, src.w[:, None] * Jy
    out = torch.empty((dst_sites.shape[0], Jx.shape[1]), dtype=Jx.dtype, device=Jx.device)
    for lo in range(0, dst_sites.shape[0], BLOCK):
        rows = dst_sites[lo:lo + BLOCK]
        dx = rows[:, None, 0] - src.sites[None, :, 0]
        dy = rows[:, None, 1] - src.sites[None, :, 1]
        r3 = (dx * dx + dy * dy + dz2) ** -1.5
        out[lo:lo + BLOCK] = prec.mm(dy * r3, aJx) - prec.mm(dx * r3, aJy)
    return out / FOUR_PI


def coupled_streams(
    systems: List[FilmSystem], Hz: Dict[str, torch.Tensor], I: Dict[str, torch.Tensor], iterations: int,
) -> Dict[str, torch.Tensor]:
    """Each film solved under ``Hz[film]`` ``(n, B)`` and its holes' currents
    ``I[film]``, then ``iterations`` rounds in which every film is solved
    again under the applied field plus the field of the other films'
    currents of the round before.  Returns the last round's streams."""
    g = {s.film.name: s.solve(Hz[s.film.name], I[s.film.name]) for s in systems}
    for _ in range(iterations):
        J = {s.film.name: s.current(g[s.film.name]) for s in systems}
        for dst in systems:
            field = Hz[dst.film.name].clone()
            for src in systems:
                if src is not dst:
                    field += biot_savart(src, *J[src.film.name], dst.sites, (dst.film.z0 - src.film.z0) ** 2, dst.prec)
            g[dst.film.name] = dst.solve(field, I[dst.film.name])
    return g


def stack_basis(
    films: List[FilmMesh], field: float, currents: Dict[str, float], iterations: int,
    prec: Precision = F64, device="cpu",
) -> Dict[str, torch.Tensor]:
    """``{film: (n, 2)}``: the streams of a uniform applied field ``field``
    (solver units) with no circulating current, and of the circulating
    currents ``{hole: current}`` in no applied field.  Every drive of the
    stack is a combination of the two: the method is linear."""
    systems = [FilmSystem(f, prec, device) for f in films]
    Hz, I = {}, {}
    for s in systems:
        Hz[s.film.name] = torch.zeros((s.n, 2), dtype=prec.dtype, device=device)
        Hz[s.film.name][:, 0] = field
        I[s.film.name] = torch.zeros((len(s.hole_names), 2), dtype=prec.dtype, device=device)
        for k, hole in enumerate(s.hole_names):
            I[s.film.name][k, 1] = currents.get(hole, 0.0)
    out = coupled_streams(systems, Hz, I, iterations)
    return {name: g.double().cpu() for name, g in out.items()}


def squid_current(film: FilmMesh, currents: Dict[str, float], prec: Precision = F64, device="cpu"):
    """One film solved alone for its circulating currents in no applied
    field: its sites, areas and sheet current ``(n, 2)``."""
    s = FilmSystem(film, prec, device)
    Hz = torch.zeros((s.n, 1), dtype=prec.dtype, device=device)
    I = torch.tensor([[currents.get(h, 0.0)] for h in s.hole_names], dtype=prec.dtype, device=device)
    g = s.solve(Hz, I.reshape(len(s.hole_names), 1))
    Jx, Jy = s.current(g)
    return s, torch.cat([Jx, Jy], dim=1)


def scan_response(
    squid: FilmSystem, squid_J: torch.Tensor, sample: FilmSystem, positions: np.ndarray,
    height: float, contour: np.ndarray, contour_z: float, current_scale: float,
) -> torch.Tensor:
    """``(B,)`` flux of ``(A / mu_0) . dl`` (trapezoid rule) around the
    pickup ``contour`` (closed, SQUID frame) of the sample currents that the
    SQUID's frozen sheet current ``squid_J`` (times ``current_scale``)
    induces, with the SQUID origin at each of ``positions`` and its plane
    ``height`` above the sample's (no holes in the sample)."""
    prec = sample.prec
    dt, device = prec.dtype, sample.sites.device
    pos = torch.as_tensor(np.asarray(positions), dtype=dt, device=device)
    B = pos.shape[0]
    # Shifting the SQUID by p is evaluating its field at sample sites - p.
    eval_pts = (sample.sites[None, :, :] - pos[:, None, :]).reshape(B * sample.n, 2)
    J = squid_J * current_scale
    Hz = biot_savart(squid, J[:, :1], J[:, 1:], eval_pts, (height + squid.film.z0 - sample.film.z0) ** 2, prec)
    Hz = Hz.reshape(B, sample.n).T.contiguous()
    g = sample.solve(Hz, torch.zeros((0, B), dtype=dt, device=device))
    Jx, Jy = sample.current(g)  # (n, B)
    pts = torch.as_tensor(np.asarray(contour), dtype=dt, device=device)
    dl = pts[1:] - pts[:-1]
    u = 0.5 * (dl + torch.roll(dl, 1, dims=0))  # vertex weights of the closed contour
    verts = pts[:-1]
    dz2 = (height + contour_z - sample.film.z0) ** 2
    flux = torch.empty(B, dtype=dt, device=device)
    for b in range(B):
        c = verts + pos[b]
        d2 = (c[:, None, 0] - sample.sites[None, :, 0]) ** 2 + (c[:, None, 1] - sample.sites[None, :, 1]) ** 2 + dz2
        rinv = torch.where(d2 > 0, torch.where(d2 > 0, d2, torch.ones_like(d2)) ** -0.5, torch.zeros_like(d2))
        R = prec.mm(u.T, rinv) * (sample.w / FOUR_PI)[None, :]  # (2, n)
        flux[b] = torch.sum(R[0] * Jx[:, b] + R[1] * Jy[:, b])
    return flux.double().cpu()
