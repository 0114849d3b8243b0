"""Batched PnP: ``solve_pnp`` and ``pose_matrix_from_p6d``.

Counterpart of ``casapose_tpu/pose/epnp.py::solve_pnp`` on its accelerator
path: the whole solve (EPnP init + LM refine) is the PnP kernel
(ops/pnp_kernel.py), which runs the CUDA kernel for CUDA tensors and its
plain version for CPU tensors. Degenerate rows (all-zero 2D points, the
reference's "missing object" convention) are swapped for a consistent
synthetic problem before the solve and come out as the placeholder pose
[rvec = 0, t = (0, 0, 1)]; non-finite kernel results are spliced to the
identity / (0, 0, 1). The JAX package's XLA ``epnp_candidates``/``_refine``
path is not ported yet.
"""

import torch

from casapose_tpu_torch.core.numerics import divide_no_nan
from casapose_tpu_torch.ops.pnp_kernel import solve_pnp_kernel, solve_pnp_plain
from casapose_tpu_torch.pose.geometry import rodrigues, rotation_to_rvec


def _project_placeholder(pts3d, K):
    """Pixels of ``pts3d`` [B, N, 3] under the placeholder pose R = I, t = (0, 0, 1)."""
    cam = pts3d + torch.tensor([0.0, 0.0, 1.0], dtype=pts3d.dtype, device=pts3d.device)
    uv = divide_no_nan(cam[..., :2], cam[..., 2:])
    return uv * torch.stack([K[0, 0], K[1, 1]]) + torch.stack([K[0, 2], K[1, 2]])


def substitute_degenerate(pts2d, pts3d, K):
    """Swap all-(near-)zero rows of ``pts2d`` for the projection under the placeholder pose.

    Returns (safe_pts2d [B, N, 2], degenerate [B] bool); the PnP kernel sees
    only ``safe_pts2d``, so all its linear algebra stays finite.
    """
    b = pts2d.shape[0]
    degenerate = torch.abs(torch.sum(pts2d.reshape(b, -1), dim=1)) < 1e-4
    return torch.where(degenerate[:, None, None], _project_placeholder(pts3d, K), pts2d), degenerate


def solve_pnp(pts2d, pts3d, K, iterations=10, plain=False):
    """Full PnP per row.

    Args:
      pts2d: [B, N, 2] (x, y) pixels; all-(near-)zero rows give the placeholder pose.
      pts3d: [B, N, 3] model points.
      K: [3, 3] intrinsics.
      plain: solve with the kernel's plain PyTorch version on any device
        (for holding the kernel against it).
    Returns:
      p6d [B, 6] = [rvec | t].
    """
    dtype, dev = pts2d.dtype, pts2d.device
    placeholder = torch.tensor([0.0, 0.0, 0.0, 0.0, 0.0, 1.0], dtype=dtype, device=dev)
    safe_pts2d, degenerate = substitute_degenerate(pts2d, pts3d, K)
    solve = solve_pnp_plain if plain else solve_pnp_kernel
    R, t, _ = solve(safe_pts2d.contiguous(), pts3d.contiguous(), K.contiguous(), iterations)
    R = torch.where(torch.isfinite(R), R, torch.eye(3, dtype=dtype, device=dev))
    t = torch.where(torch.isfinite(t), t, placeholder[3:])
    p6d = torch.cat([rotation_to_rvec(R), t], dim=1)
    p6d = torch.where(torch.isfinite(p6d), p6d, torch.zeros_like(p6d))
    return torch.where(degenerate[:, None], placeholder, p6d)


def pose_matrix_from_p6d(p6d):
    """[B, 6] -> [B, 3, 4], negated where t_z < 0 (the reference's sign fix)."""
    R = rodrigues(p6d[:, 0:3])
    t = p6d[:, 3:6, None]
    RT = torch.cat([R, t], dim=-1)
    return torch.where(t[:, 2:3] < 0, -RT, RT)
