"""FFT inter-film Biot-Savart coupling.

Counterpart of ``superscreen_tpu/ops/fft_coupling.py``.  For films
separated by ``dz > 0`` the field of a sheet current with stream function
``g`` is diagonal in Fourier space,

.. math::

    \\hat{H}_z(\\vec{k}, dz) = \\tfrac{k}{2} e^{-k\\,dz}\\, \\hat{g}(\\vec{k}),

so instead of the ``O(n_a n_b)`` pairwise sum a coupling round

1. interpolates each source film's ``g`` onto a regular grid (piecewise
   linear on the source mesh, zero outside the film and inside its holes),
2. takes ``rfft2``, multiplies by the transfer ``(k/2) e^{-k dz}`` and sums
   the sources of each destination in Fourier space, one ``irfft2``,
3. samples the grid field at the destination sites (bilinear).

The errors are the reference's: FFT wraparound (~``pad_factor^-3``) and
the discrete kernel's quadrature error; same-plane films must use the
exact kernel.  The transforms are ``torch.fft`` (cuFFT on the card), the
counterpart of the XLA FFTs the JAX package runs outside any Pallas
kernel; the mesh<->grid operators are gathers with a fixed fan-in (3
mesh sites per grid point, 4 grid points per mesh site).

The grid data is built once on the host.  Grid points are located with the
package's float64 triangle index (:mod:`.interp`) where the JAX package
uses matplotlib's trifinder; a point on an edge of the film's outline
counts as inside and one a rounding step beyond it as outside, as the
trifinder decides (at a vertex of the outline the trifinder's answer
depends on its search tree, and the port counts the point as inside).
The barycentric weights are formed in float64 as the JAX package forms
them, then cast to the solve dtype.
"""

from typing import Dict, NamedTuple

import numpy as np
import torch

from ..device.mesh_generation import get_edges
from . import interp

__all__ = [
    "FilmGridData",
    "build_film_grid_data",
    "fft_coupling_field",
    "fft_fields_from_spectra",
    "fft_source_spectrum",
    "friendly_grid_size",
]


class FilmGridData(NamedTuple):
    """Per-film grid interpolation data for FFT coupling, as tensors on the
    model's torch device.

    The grid is shared by all films of a device (one bounding box, padded);
    each film's mesh->grid interpolation covers only its own bounding
    SUBGRID ``(Gsx, Gsy)`` at offset ``(off_x, off_y)`` in the full grid.

    ``m2g_tri``/``m2g_w``: ``(Gsx, Gsy, 3)`` triangle corner indices and
    barycentric weights of each subgrid point (weights 0 outside the
    film).  ``g2m_idx``/``g2m_w``: ``(n, 4)`` flattened full-grid indices
    and bilinear weights of each mesh site.  ``kmag``: ``|k|`` on the
    rfft2 grid, ``(G, G // 2 + 1)``.
    """

    m2g_tri: torch.Tensor
    m2g_w: torch.Tensor
    off_x: int
    off_y: int
    g2m_idx: torch.Tensor
    g2m_w: torch.Tensor
    kmag: torch.Tensor


def friendly_grid_size(n: int) -> int:
    """The smallest EVEN 5-smooth (``2^a 3^b 5^c``) integer ``>= n``: FFTs
    of small-prime sizes are fast, and snapping to the next power of two
    would overshoot by up to 2x per axis."""
    n = max(2, int(n))
    m = n + (n % 2)
    while True:
        k = m
        for p in (2, 3, 5):
            while k % p == 0:
                k //= p
        if k == 1:
            return m
        m += 2


def _grid_axes(all_sites, h, pad_factor=3.0):
    """A common square grid covering all films with zero-padding margin:
    ``(x, y, spacing)``."""
    mins = np.min([s.min(axis=0) for s in all_sites], axis=0)
    maxs = np.max([s.max(axis=0) for s in all_sites], axis=0)
    center = 0.5 * (mins + maxs)
    span = float((maxs - mins).max()) * pad_factor
    G = friendly_grid_size(int(np.ceil(span / h + 1)))
    x = center[0] - span / 2 + np.arange(G) * (span / G)
    y = center[1] - span / 2 + np.arange(G) * (span / G)
    return x, y, span / G


def mean_edge_spacing(meshes) -> float:
    """The default grid spacing: the smallest mean mesh edge length among
    the films."""
    return min(float(np.mean(m.edge_mesh.edge_lengths)) for m in meshes.values())


def _find_triangles(sites: np.ndarray, elements: np.ndarray, points: np.ndarray):
    """Containing triangle of each point, or -1 outside the mesh.

    The triangle comes from :func:`interp.locate` (float64, with its
    tolerance on shared edges, where either neighbour gives the same
    value).  On the mesh's outline the decision is exact: a point counts as
    inside only if it lies on the inner side of, or on, each boundary edge
    of its triangle by the sign of a float64 cross product, so a point on
    the outline is inside and one a rounding step beyond it is outside, as
    matplotlib's trifinder decides."""
    index = interp.build_triangle_index(sites, elements, "cpu")
    tri, _, found = interp.locate(index, torch.as_tensor(points, dtype=torch.float64))
    tri, inside = tri.numpy(), found.numpy().copy()
    edges, is_boundary = get_edges(elements)
    n = len(sites)
    boundary_keys = edges[is_boundary, 0] * n + edges[is_boundary, 1]
    corners = elements[tri]  # (k, 3)
    a, b, c = (sites[corners[:, j]] for j in range(3))
    det = (b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1]) - (b[:, 1] - a[:, 1]) * (c[:, 0] - a[:, 0])
    sign = np.sign(det)
    for i0, i1 in ((0, 1), (1, 2), (2, 0)):
        v0, v1 = corners[:, i0], corners[:, i1]
        on_outline = np.isin(np.minimum(v0, v1) * n + np.maximum(v0, v1), boundary_keys)
        p0, p1 = sites[v0], sites[v1]
        cross = (p1[:, 0] - p0[:, 0]) * (points[:, 1] - p0[:, 1]) - (p1[:, 1] - p0[:, 1]) * (
            points[:, 0] - p0[:, 0]
        )
        inside &= ~on_outline | (sign * cross >= 0)
    return np.where(inside, tri, -1)


def build_film_grid_data(
    device, torch_device, h: float = None, pad_factor: float = 3.0
) -> Dict[str, FilmGridData]:
    """Builds per-film grid interpolation data for FFT coupling.

    Args:
        device: A meshed :class:`Device`.
        torch_device: Where the tensors live.
        h: Grid spacing (defaults to :func:`mean_edge_spacing`).
        pad_factor: Bounding-box padding against FFT wraparound.

    Returns:
        ``{film_name: FilmGridData}``.
    """
    meshes = device.meshes
    all_sites = [m.sites for m in meshes.values()]
    if h is None:
        h = mean_edge_spacing(meshes)
    gx, gy, dx = _grid_axes(all_sites, h, pad_factor)
    G = len(gx)
    XX, YY = np.meshgrid(gx, gy, indexing="ij")
    grid_pts = np.stack([XX.ravel(), YY.ravel()], axis=1)

    kx = 2 * np.pi * np.fft.fftfreq(G, d=dx)
    ky = 2 * np.pi * np.fft.rfftfreq(G, d=dx)
    kmag = np.sqrt(kx[:, None] ** 2 + ky[None, :] ** 2)

    out = {}
    dtype = np.dtype(device.solve_dtype)

    def put(array):
        return torch.as_tensor(array, device=torch_device)

    for name, mesh in meshes.items():
        sites = mesh.sites
        # The film's bounding subgrid (one cell of slack each side): the
        # mesh->grid interpolation only ever produces nonzeros there.
        ix_lo = int(np.clip(np.floor((sites[:, 0].min() - gx[0]) / dx) - 1, 0, G - 1))
        ix_hi = int(np.clip(np.ceil((sites[:, 0].max() - gx[0]) / dx) + 2, 1, G))
        iy_lo = int(np.clip(np.floor((sites[:, 1].min() - gy[0]) / dx) - 1, 0, G - 1))
        iy_hi = int(np.clip(np.ceil((sites[:, 1].max() - gy[0]) / dx) + 2, 1, G))
        gsx, gsy = ix_hi - ix_lo, iy_hi - iy_lo
        sub_pts = grid_pts.reshape(G, G, 2)[ix_lo:ix_hi, iy_lo:iy_hi].reshape(-1, 2)
        # mesh -> grid: barycentric weights of each subgrid point's triangle.
        t_idx = _find_triangles(sites, mesh.elements, sub_pts)
        gi = np.flatnonzero(t_idx >= 0)
        tris = mesh.elements[t_idx[gi]]
        p = sub_pts[gi]
        a, b, c = (sites[tris[:, k]] for k in range(3))
        det = (b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1]) - (b[:, 1] - a[:, 1]) * (c[:, 0] - a[:, 0])
        w0 = (
            (b[:, 0] - p[:, 0]) * (c[:, 1] - p[:, 1]) - (b[:, 1] - p[:, 1]) * (c[:, 0] - p[:, 0])
        ) / det
        w1 = (
            (c[:, 0] - p[:, 0]) * (a[:, 1] - p[:, 1]) - (c[:, 1] - p[:, 1]) * (a[:, 0] - p[:, 0])
        ) / det
        w2 = 1.0 - w0 - w1
        m2g_tri = np.zeros((gsx * gsy, 3), dtype=np.int64)
        m2g_w = np.zeros((gsx * gsy, 3), dtype=dtype)
        m2g_tri[gi] = tris
        m2g_w[gi] = np.stack([w0, w1, w2], axis=1)

        # grid -> mesh: bilinear weights of the 4 surrounding grid points.
        fx = (sites[:, 0] - gx[0]) / dx
        fy = (sites[:, 1] - gy[0]) / dx
        ix0 = np.clip(np.floor(fx).astype(int), 0, G - 2)
        iy0 = np.clip(np.floor(fy).astype(int), 0, G - 2)
        tx = np.clip(fx - ix0, 0.0, 1.0)
        ty = np.clip(fy - iy0, 0.0, 1.0)
        g2m_idx = np.stack(
            [ix0 * G + iy0, (ix0 + 1) * G + iy0, ix0 * G + (iy0 + 1), (ix0 + 1) * G + (iy0 + 1)],
            axis=1,
        ).astype(np.int64)
        g2m_w = np.stack(
            [(1 - tx) * (1 - ty), tx * (1 - ty), (1 - tx) * ty, tx * ty], axis=1
        ).astype(dtype)

        out[name] = FilmGridData(
            m2g_tri=put(m2g_tri.reshape(gsx, gsy, 3)),
            m2g_w=put(m2g_w.reshape(gsx, gsy, 3)),
            off_x=ix_lo,
            off_y=iy_lo,
            g2m_idx=put(g2m_idx),
            g2m_w=put(g2m_w),
            kmag=put(kmag.astype(dtype)),
        )
    return out


def grid_values(src: FilmGridData, g: torch.Tensor) -> torch.Tensor:
    """``g`` ``(B, n)`` interpolated onto the film's subgrid: three gathers,
    ``(B, Gsx, Gsy)``."""
    return sum(src.m2g_w[None, :, :, k] * g[:, src.m2g_tri[:, :, k]] for k in range(3))


def fft_source_spectrum(src: FilmGridData, g: torch.Tensor) -> torch.Tensor:
    """``rfft2`` of the source stream function on the grid: ``g`` ``(B, n)``
    -> ``(B, G, G // 2 + 1)`` complex.  The subgrid values are written into
    a zero ``(B, G, G)`` grid at the film's offset (never a scatter)."""
    G = src.kmag.shape[0]
    sub = grid_values(src, g)
    full = torch.zeros((g.shape[0], G, G), dtype=g.dtype, device=g.device)
    full[:, src.off_x : src.off_x + sub.shape[1], src.off_y : src.off_y + sub.shape[2]] = sub
    return torch.fft.rfft2(full)


def fft_fields_from_spectra(dst: FilmGridData, spectra, dzs) -> torch.Tensor:
    """Total field at the destination sites from several source spectra.

    Each spectrum is scaled by its transfer ``(k/2) e^{-k dz}`` and the
    sources are summed in Fourier space, so a destination pays one
    ``irfft2`` and one grid->mesh gather per round whatever the number of
    sources.  The sum is accumulated in place, one source at a time, so
    the spectra are never copied into a stack.

    Args:
        dst: Destination grid data.
        spectra: The ``S`` source spectra, each ``(B, G, G // 2 + 1)``: a
            sequence, or a stacked ``(S, B, G, G // 2 + 1)`` tensor.
        dzs: ``(S,)`` layer separations ``|z_dst - z_src|`` (> 0).

    Returns:
        ``(B, n_dst)`` ``H_z`` at the destination sites.
    """
    k = dst.kmag
    acc = torch.zeros_like(spectra[0])  # (B, G, G//2+1)
    acc_re = torch.view_as_real(acc)
    for spectrum, dz in zip(spectra, dzs):
        transfer = 0.5 * k * torch.exp(-k * abs(float(dz)))  # real (G, G//2+1)
        acc_re.addcmul_(torch.view_as_real(spectrum), transfer[..., None])
    G = k.shape[0]
    flat = torch.fft.irfft2(acc, s=(G, G)).reshape(acc.shape[0], G * G)
    # Bilinear sampling: exactly 4 grid reads per site.
    return sum(dst.g2m_w[None, :, j] * flat[:, dst.g2m_idx[:, j]] for j in range(4))


def fft_coupling_field(
    src: FilmGridData, dst: FilmGridData, spectrum: torch.Tensor, dz: float
) -> torch.Tensor:
    """Field at the destination sites from one precomputed source spectrum
    ``(B, G, G // 2 + 1)`` at separation ``dz``: ``(B, n_dst)``.  ``src``
    and ``dst`` must share one grid."""
    return fft_fields_from_spectra(dst, spectrum[None], [dz])
