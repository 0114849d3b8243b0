"""Rotation helpers on tensors: the device half of ``casapose_tpu/pose/geometry.py``.

``rodrigues`` (axis-angle -> matrix) and ``rotation_to_rvec`` (its log map),
batched, with the JAX package's guards for theta ~ 0 and theta ~ pi.
"""

import math

import torch

from casapose_tpu_torch.core.numerics import divide_no_nan


def rodrigues(rvecs):
    """Axis-angle vectors [B, 3] -> rotation matrices [B, 3, 3]; zero angle gives identity."""
    b = rvecs.shape[0]
    thetas = torch.linalg.vector_norm(rvecs, dim=1, keepdim=True)
    is_zero = (thetas[:, 0] == 0.0)[:, None, None]
    u = rvecs / torch.where(thetas == 0.0, torch.ones_like(thetas), thetas)
    zero = torch.zeros(b, dtype=rvecs.dtype, device=rvecs.device)
    K = torch.stack(
        [
            torch.stack([zero, -u[:, 2], u[:, 1]], dim=1),
            torch.stack([u[:, 2], zero, -u[:, 0]], dim=1),
            torch.stack([-u[:, 1], u[:, 0], zero], dim=1),
        ],
        dim=1,
    )
    eye = torch.eye(3, dtype=rvecs.dtype, device=rvecs.device).expand(b, 3, 3)
    sin_t = torch.sin(thetas)[..., None]
    cos_t = torch.cos(thetas)[..., None]
    R = eye + sin_t * K + (1.0 - cos_t) * (K @ K)
    return torch.where(is_zero, eye, R)


def rotation_to_rvec(R):
    """Rotation matrices [B, 3, 3] -> axis-angle vectors [B, 3], without NaN at theta ~ 0 or ~ pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    theta = torch.arccos(torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0))
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    small = theta < 1e-5
    near_pi = theta > math.pi - 1e-3
    generic_scale = divide_no_nan(theta, 2.0 * torch.sin(theta))[..., None]
    rvec_generic = w * torch.where(small[..., None], torch.full_like(generic_scale, 0.5), generic_scale)
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis = torch.sqrt(torch.clamp((diag + 1.0) * 0.5, 0.0, 1.0))
    signs = torch.stack(
        [torch.sign(R[..., 0, 1] + R[..., 1, 0]), torch.ones_like(theta), torch.sign(R[..., 1, 2] + R[..., 2, 1])],
        dim=-1,
    )
    signs = torch.where(signs == 0, torch.ones_like(signs), signs)
    rvec_pi = axis * signs * theta[..., None]
    return torch.where(near_pi[..., None], rvec_pi, rvec_generic)
