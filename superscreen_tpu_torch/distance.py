"""Pairwise distances and the q matrix.

Counterpart of ``superscreen_tpu/distance.py``: NumPy in and NumPy out.
:func:`q_matrix` is assembled on ``torch_device`` (the card unless the
caller asks for the CPU) by :func:`superscreen_tpu_torch.ops.kernels.q_matrix`,
which on a CUDA device launches the hand-written ``q_matrix`` kernel, and
:func:`cdist` on ``torch_device`` too by
:func:`superscreen_tpu_torch.ops.kernels.cdist`.  The
``(sq)euclidean_distance_{2d,3d}`` functions are NumPy on the host, as in
the JAX package.
"""

import numpy as np
import torch

from .ops import kernels as _kernels

__all__ = [
    "cdist",
    "q_matrix",
    "sqeuclidean_distance_2d",
    "sqeuclidean_distance_3d",
    "euclidean_distance_2d",
    "euclidean_distance_3d",
]


def _pairwise_sq(XA: np.ndarray, XB: np.ndarray, ndim: int) -> np.ndarray:
    XA = np.asarray(XA, dtype=float)
    XB = np.asarray(XB, dtype=float)
    if XA.shape[1] != ndim or XB.shape[1] != ndim:
        raise ValueError(f"Expected (n, {ndim}) arrays, got {XA.shape} and {XB.shape}.")
    diff = XA[:, None, :] - XB[None, :, :]
    return np.einsum("ijk,ijk->ij", diff, diff)


def sqeuclidean_distance_2d(XA: np.ndarray, XB: np.ndarray) -> np.ndarray:
    """Squared Euclidean distances between 2D point sets."""
    return _pairwise_sq(XA, XB, 2)


def sqeuclidean_distance_3d(XA: np.ndarray, XB: np.ndarray) -> np.ndarray:
    """Squared Euclidean distances between 3D point sets."""
    return _pairwise_sq(XA, XB, 3)


def euclidean_distance_2d(XA: np.ndarray, XB: np.ndarray) -> np.ndarray:
    """Euclidean distances between 2D point sets."""
    return np.sqrt(_pairwise_sq(XA, XB, 2))


def euclidean_distance_3d(XA: np.ndarray, XB: np.ndarray) -> np.ndarray:
    """Euclidean distances between 3D point sets."""
    return np.sqrt(_pairwise_sq(XA, XB, 3))


def cdist(
    XA: np.ndarray, XB: np.ndarray, metric: str = "euclidean", torch_device="cuda"
) -> np.ndarray:
    """Pairwise distances between observations in 2D or 3D space.

    Args:
        XA: ``(mA, n)`` array with n in (2, 3).
        XB: ``(mB, n)`` array with n in (2, 3).
        metric: "euclidean" or "sqeuclidean".
        torch_device: ``"cuda"`` (default; raises without a card) or
            ``"cpu"``.

    Returns:
        ``(mA, mB)`` distance matrix.
    """
    XA = np.asarray(XA)
    XB = np.asarray(XB)
    metrics = ("euclidean", "sqeuclidean")
    if metric not in metrics:
        raise ValueError(f"Metric must be one of {metrics!r}, got {metric!r}.")
    if XA.shape[1] != XB.shape[1]:
        raise ValueError(
            f"XA.shape[1] ({XA.shape[1]}) must be equal to XB.shape[1] ({XB.shape[1]})."
        )
    if XA.shape[1] not in (2, 3):
        raise ValueError(
            f"Expected shape (n, 2) or (n, 3) arrays, got {XA.shape} and {XB.shape}."
        )
    from .solver.solve import resolve_torch_device

    torch_device = resolve_torch_device(torch_device)
    XA = torch.as_tensor(XA, device=torch_device)
    XB = torch.as_tensor(XB, device=torch_device)
    return _kernels.cdist(XA, XB, metric=metric).cpu().numpy()


def q_matrix(points: np.ndarray, dtype=None, torch_device="cuda") -> np.ndarray:
    """The matrix ``q_ij = 1/(4 pi |r_i - r_j|^3)`` with zero diagonal.

    Args:
        points: ``(n, 2)`` coordinates.
        dtype: Float dtype of the computation and the result (default:
            that of ``points``).
        torch_device: ``"cuda"`` (default; raises without a card) or
            ``"cpu"`` (the plain PyTorch version).
    """
    from .solver.solve import resolve_torch_device

    points = np.asarray(points, dtype=dtype)
    sites = torch.as_tensor(points, device=resolve_torch_device(torch_device))
    return _kernels.q_matrix(sites).cpu().numpy()
