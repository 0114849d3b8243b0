"""Geometric primitives: counterpart of ``casapose_tpu/pose/geometry.py``.

On tensors: ``rodrigues`` (axis-angle -> matrix) and ``rotation_to_rvec``
(its log map), batched, with the JAX package's guards for theta ~ 0 and
theta ~ pi; ``project_batch``; ``transform_points_back_batch``, which undoes
the loader's crop / rotate / translate / scale on 2D points. On numpy, for
the dataset and the visual dumps: the 2D rotation matrix, the forward point
map, the loader's offsets, projection, quaternions and fixed model
transforms, and the dataset converter's quaternion, homogeneous matrix and
field of view, copied from the JAX package's host half.
"""

import math

import numpy as np
import torch

from casapose_tpu_torch.core.numerics import divide_no_nan, f32_pinned


@f32_pinned
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


@f32_pinned
def project_batch(xyz, K, RT):
    """Project model points with one pose per batch element.

    Args:
      xyz: [B, N, 3] model-frame points.
      K: [3, 3] shared intrinsics, or [B, 3, 3].
      RT: [B, 3, 4] rigid transforms.
    Returns:
      (xy [B, N, 2] pixels, 0 where the depth is 0; xyz_cam [B, N, 3]).
    """
    xyz_cam = xyz @ RT[:, :, :3].transpose(1, 2) + RT[:, :, 3:].transpose(1, 2)
    uvw = xyz_cam @ (K.T[None] if K.ndim == 2 else K.transpose(-1, -2))
    return divide_no_nan(uvw[:, :, :2], uvw[:, :, 2:]), xyz_cam


@f32_pinned
def transform_points_back_batch(points, h_crop, w_crop, sx, sy, dx, dy, angle, scale):
    """Undo the loader's crop, rotation, translation and scale on 2D points.

    Args:
      points: [B, N, 2] (x, y) points in network-output pixels.
      h_crop, w_crop, sx, sy, dx, dy, angle, scale: [B, 1] columns of the
        offsets tensor ([h_crop, w_crop, out_h, out_w, dx, dy, angle, scale,
        orig_w, orig_h]; sx = orig_w, sy = orig_h).
    Returns: [B, N, 2] points in original-image pixels.
    """
    b, n = points.shape[0], points.shape[1]
    pts = points / scale[..., None]
    z = torch.zeros_like(dx)
    o = torch.ones_like(dx)
    tm = torch.stack([torch.cat([o, z, -dx], 1), torch.cat([z, o, -dy], 1), torch.cat([z, z, o], 1)], 1)
    angle_rad = -angle * (math.pi / 180.0)
    a = torch.cos(angle_rad)
    bb = torch.sin(angle_rad)
    cx = sx[:, 0] / 2.0
    cy = sy[:, 0] / 2.0
    c = ((1.0 - a[:, 0]) * cx - bb[:, 0] * cy)[:, None]
    d = (bb[:, 0] * cx + (1.0 - a[:, 0]) * cy)[:, None]
    rm = torch.stack([torch.cat([a, bb, c], 1), torch.cat([-bb, a, d], 1), torch.cat([z, z, o], 1)], 1)
    pts = pts + torch.cat([w_crop, h_crop], 1)[:, None, :]
    homo = torch.cat([pts.transpose(1, 2), torch.ones((b, 1, n), dtype=points.dtype, device=points.device)], 1)
    return (rm @ (tm @ homo))[:, 0:2].transpose(1, 2)


# ----------------------------------------------------------------- host (numpy), for the dataset


def get_rotation_matrix_2D_np(center, angle):
    """2x3 rotation about ``center`` (the reference's sign convention)."""
    angle_rad = angle * (np.pi / 180.0)
    a = np.cos(angle_rad)
    b = np.sin(angle_rad)
    c = (1 - a) * center[0] - b * center[1]
    d = b * center[0] + (1 - a) * center[1]
    return np.float32([[a, b, c], [-b, a, d]])


def reproject_np(points, tm, rm, offset):
    """Apply the 2x3 rotation ``rm``, then the translation ``tm``, then subtract the crop offset."""
    pts = np.asarray(points, dtype=np.float64)
    rmat = np.identity(3)
    rmat[0:2] = rm
    tmat = np.identity(3)
    tmat[0:2] = tm
    out = tmat @ (rmat @ np.vstack((pts.T, np.ones(len(pts)))))
    return out[0:2].T - offset


def apply_offsets_np(points, offsets):
    """Map original-image points into the augmented network input (the forward map that
    :func:`transform_points_back_batch` inverts); offsets are the loader's [h_crop, w_crop, out_h, out_w, dx, dy,
    angle, scale, orig_w, orig_h]."""
    h_crop, w_crop = offsets[0], offsets[1]
    sx, sy = offsets[8], offsets[9]
    dx, dy, angle, scale = offsets[4], offsets[5], offsets[6], offsets[7]
    tm = np.float32([[1, 0, dx], [0, 1, dy]])
    rm = get_rotation_matrix_2D_np((sx / 2, sy / 2), angle)
    return reproject_np(points, tm, rm, [w_crop, h_crop]) * scale


def project_np(xyz, K, RT):
    """Projection of [N, 3] points on the host: (xy [N, 2], xyz_cam [N, 3])."""
    xyz_cam = np.dot(xyz, RT[:, :3].T) + RT[:, 3:].T
    uvw = np.dot(xyz_cam, K.T)
    return uvw[:, :2] / uvw[:, 2:], xyz_cam


def transform_points_np(points, transform):
    """Apply a 3x4 / 4x4 model transform to [N, 3] points."""
    p = np.asarray(points, dtype=np.float64)
    p = np.transpose(np.c_[p, np.ones(len(p))])
    return np.transpose(np.matmul(transform, p))[:, 0:3]


def quaternion_matrix_np(quaternion_xyzw, translation=None, wxyz_input=False):
    """Quaternion (xyzw unless ``wxyz_input``) -> 3x3 rotation, or 3x4 [R | t] with ``translation``.

    Near-zero quaternions give the identity.
    """
    q = np.array(quaternion_xyzw, dtype=np.float64, copy=True)
    if not wxyz_input:
        q = np.array([q[3], q[0], q[1], q[2]], dtype=np.float64)
    n = np.dot(q, q)
    if n < 0.0001:
        R = np.identity(3)
    else:
        q *= math.sqrt(2.0 / n)
        q = np.outer(q, q)
        R = np.array(
            [
                [1.0 - q[2, 2] - q[3, 3], q[1, 2] - q[3, 0], q[1, 3] + q[2, 0]],
                [q[1, 2] + q[3, 0], 1.0 - q[1, 1] - q[3, 3], q[2, 3] - q[1, 0]],
                [q[1, 3] - q[2, 0], q[2, 3] + q[1, 0], 1.0 - q[1, 1] - q[2, 2]],
            ]
        )
    if translation is None:
        return R
    t = np.array(translation, dtype=np.float64, copy=True).reshape(3, 1)
    return np.concatenate([R, t], axis=1)


def matrix_to_quaternion_np(M):
    """Rotation matrix -> xyzw quaternion (w >= 0)."""
    Qxx, Qyx, Qzx, Qxy, Qyy, Qzy, Qxz, Qyz, Qzz = np.asarray(M).flat
    K = (
        np.array(
            [
                [Qxx - Qyy - Qzz, 0, 0, 0],
                [Qyx + Qxy, Qyy - Qxx - Qzz, 0, 0],
                [Qzx + Qxz, Qzy + Qyz, Qzz - Qxx - Qyy, 0],
                [Qyz - Qzy, Qzx - Qxz, Qxy - Qyx, Qxx + Qyy + Qzz],
            ]
        )
        / 3.0
    )
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[0, 1, 2, 3], np.argmax(vals)]
    if q[3] < 0:
        q *= -1
    return q


def create_transformation_matrix_np(R, t):
    """Stack R (3x3) and t (3,) into a homogeneous 4x4 matrix."""
    out = np.identity(4)
    out[:3, :3] = np.asarray(R)[:3, :3]
    out[:3, 3] = np.asarray(t).reshape(3)
    return out


def get_horizontal_width_angle_np(width, height, fx, fy):
    """Horizontal field of view in degrees (offline tooling helper)."""
    aspect = width / fx * (fy / height)
    return np.rad2deg(2.0 * np.arctan(aspect * (0.5 / (fy / height))))
