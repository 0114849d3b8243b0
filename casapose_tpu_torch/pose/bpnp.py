"""Differentiable PnP as a layer: ``bpnp_pose``, counterpart of ``casapose_tpu/pose/bpnp.py``.

The forward solves PnP with ``solve_pnp``: the PnP kernel on the card, its
plain version on the CPU (or inside ``ops/plain.py::plain_kernels("pnp")``).
The backward differentiates the solution through the stationarity condition
of the reprojection objective

    g(y; x, z, K) = sum_i || proj(y, z_i, K) - x_i ||^2,   f = dg/dy = 0,

so that dy/dq = -(df/dy)^-1 (df/dq) for q in {x (2D points), z (3D points),
K}, step by step as the JAX ``custom_vjp`` does: the Hessian df/dy made
symmetric, Jacobi equilibration, damping 1e-5 * I, an unrolled 6x6
Cholesky solve, the Jacobians of f with respect to x [6, N, 2], z [6, N, 3]
and K [6, 3, 3], rows with a non-finite result zeroed, d_K summed over the
batch. The Jacobians come from ``torch.func`` (``jacfwd`` of ``grad``,
``vmap`` over the batch), in full float32.
"""

import torch
from torch.func import grad, jacfwd, vmap

from casapose_tpu_torch.core.numerics import divide_no_nan, f32_precision
from casapose_tpu_torch.pose.epnp import solve_pnp


def _rodrigues(rvec):
    """One axis-angle vector [3] -> R [3, 3]; identity at zero angle.

    The angle is sqrt(sum(r^2)), as ``jnp.linalg.norm`` computes it, so that
    its derivatives at zero are as non-finite as JAX's (such rows are zeroed).
    """
    theta = torch.sqrt(torch.sum(rvec * rvec))
    is_zero = theta == 0.0
    u = rvec / torch.where(is_zero, torch.ones_like(theta), theta)
    zero = torch.zeros_like(theta)
    Kx = torch.stack([torch.stack([zero, -u[2], u[1]]), torch.stack([u[2], zero, -u[0]]),
                      torch.stack([-u[1], u[0], zero])])
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    R = eye + torch.sin(theta) * Kx + (1.0 - torch.cos(theta)) * (Kx @ Kx)
    return torch.where(is_zero, eye, R)


def _residuals(p6d, pts3d, K):
    """Reprojections [N, 2] of ``pts3d`` [N, 3] under one pose ``p6d`` = [rvec | t] (``epnp.py::_residuals``)."""
    R = _rodrigues(p6d[0:3])
    cam = pts3d @ R.T + p6d[3:6]
    uv = divide_no_nan(cam[:, :2], cam[:, 2:])
    return uv * torch.stack([K[0, 0], K[1, 1]]) + torch.stack([K[0, 2], K[1, 2]])


def _objective(p6d, pts2d, pts3d, K):
    r = _residuals(p6d, pts3d, K) - pts2d
    return torch.sum(r * r)


_stationarity = grad(_objective, argnums=0)  # f = dg/dy, [6]


def _cholesky_solve_spd(A, b):
    """Solve A x = b for SPD A [..., n, n] with a fully unrolled Cholesky (``epnp.py::_cholesky_solve_spd``)."""
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = torch.sqrt(torch.clamp(s, min=1e-30)) if i == j else s / L[j][j]
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


def ift_vjp(g_out, p6d, pts2d, pts3d, K):
    """Implicit-function VJP of a batch of PnP solves.

    Args: g_out [B, 6] upstream gradient, p6d [B, 6] the solutions, pts2d
    [B, N, 2], pts3d [B, N, 3], K [3, 3].
    Returns: (d_pts2d [B, N, 2], d_pts3d [B, N, 3], d_K [B, 3, 3]), each row
    zeroed where any of its three parts is not finite.
    """
    jac = vmap(jacfwd(_stationarity, argnums=(0, 1, 2, 3)), in_dims=(0, 0, 0, None))
    J_fy, J_fx, J_fz, J_fK = jac(p6d, pts2d, pts3d, K)  # [B,6,6], [B,6,N,2], [B,6,N,3], [B,6,3,3]
    H = 0.5 * (J_fy + J_fy.transpose(-1, -2))
    d_inv = torch.rsqrt(torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1), min=1e-12))
    Hn = H * d_inv[:, :, None] * d_inv[:, None, :] + 1e-5 * torch.eye(6, dtype=H.dtype, device=H.device)
    w = -d_inv * _cholesky_solve_spd(Hn, d_inv * g_out)  # [B, 6]
    d_x = torch.einsum("bi,binm->bnm", w, J_fx)
    d_z = torch.einsum("bi,binm->bnm", w, J_fz)
    d_K = torch.einsum("bi,binm->bnm", w, J_fK)
    finite = (torch.isfinite(d_x).flatten(1).all(1) & torch.isfinite(d_z).flatten(1).all(1)
              & torch.isfinite(d_K).flatten(1).all(1))
    keep = lambda d: torch.where(finite[:, None, None], d, torch.zeros_like(d))  # noqa: E731
    return keep(d_x), keep(d_z), keep(d_K)


class _BPnP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pts2d, pts3d, K):
        p6d = solve_pnp(pts2d, pts3d, K)
        ctx.save_for_backward(p6d, pts2d, pts3d, K)
        return p6d

    @staticmethod
    def backward(ctx, g_out):
        p6d, pts2d, pts3d, K = ctx.saved_tensors
        with f32_precision():
            d_x, d_z, d_K = ift_vjp(g_out, p6d, pts2d, pts3d, K)
        return d_x, d_z, torch.sum(d_K, dim=0)


def bpnp_pose(pts2d, pts3d, K):
    """Differentiable batched PnP.

    Args:
      pts2d: [B, N, 2] (x, y) pixels (all-zero rows give the placeholder pose).
      pts3d: [B, N, 3] model points.
      K: [3, 3] intrinsics.
    Returns: p6d [B, 6] = [rvec | t]; gradients reach pts2d, pts3d and K
    through the implicit-function backward.
    """
    return _BPnP.apply(pts2d, pts3d, K)
