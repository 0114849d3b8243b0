"""Pose-accuracy metrics: 2D reprojection error, ADD and ADD-S, batched.

Counterpart of ``casapose_tpu/pose/metrics.py::evaluate_poses``:

  * 2D error: mean pixel distance between the GT-pose and estimated-pose
    projections of the evaluation vertices;
  * ADD: mean 3D distance between corresponding transformed vertices;
  * ADD-S (symmetric objects): mean closest-point distance, with the
    reference's sqrt(|min d^2| + 1e-5) numerics;
  * symmetric objects are those whose eval mesh has 7862 or 3417 vertices
    (eggbox and glue on LM/LMO, the reference's rule), unless a mask is given.

Bookkeeping as in the JAX package: a missing object (GT present, no pose)
counts as missing and contributes the sentinels 99.9 (2D) and 999.9 (3D);
a pose where GT says the object is absent is a false positive; 3D valid is
err < 0.1 * diameter, 2D valid is err < ``allowed_error_2d`` px.

ADD-S tiles both point sets: the JAX package takes [M, V, 4096] blocks
(33 GB of float32 at M = 256, V = 7862); here blocks are at most
``_TILE`` x ``_TILE`` points for ``_ROWS`` objects at a time. Which objects
are symmetric is fixed for a run by its eval meshes: given as
``symmetric_objects`` (a tuple of object indices, :func:`symmetric_objects`
of the meshes' vertex counts), ADD-S runs on those objects' rows only;
otherwise (a ``symmetric_mask`` tensor, or the rule on the counts tensor)
on every row, selected afterwards, as the JAX package does. Neither reads a
value back to the host.
"""

import numpy as np
import torch

from casapose_tpu_torch.core.numerics import divide_no_nan, f32_precision

DEFAULT_SYMMETRIC_VERTEX_COUNTS = (7862, 3417)  # eggbox, glue (the reference's rule)
_TILE = 1024
_ROWS = 64  # objects per block: 64 x 1024 x 1024 float32 = 256 MB


def _closest_point_mean(A, B, valid_a, valid_b):
    """mean_i min_j ||A_i - B_j|| over valid points; A, B [M, V, 3], valid_a float [M, V], valid_b bool [M, V]."""
    m, v, _ = A.shape
    a_sq = torch.sum(A * A, dim=-1)
    b_sq = torch.sum(B * B, dim=-1)
    best = torch.full((m, v), float("inf"), dtype=A.dtype, device=A.device)
    inf = torch.full((), float("inf"), dtype=A.dtype, device=A.device)
    for r0 in range(0, m, _ROWS):
        rows = slice(r0, r0 + _ROWS)
        for i0 in range(0, v, _TILE):
            ti = slice(i0, i0 + _TILE)
            block_best = best[rows, ti]
            for j0 in range(0, v, _TILE):
                tj = slice(j0, j0 + _TILE)
                cross = torch.bmm(A[rows, ti], B[rows, tj].transpose(1, 2))
                d2 = a_sq[rows, ti, None] - 2.0 * cross + b_sq[rows, None, tj]
                d2 = torch.where(valid_b[rows, None, tj], d2, inf)
                block_best = torch.minimum(block_best, d2.amin(dim=-1))
            best[rows, ti] = block_best
    best = torch.where(torch.isinf(best), torch.zeros_like(best), best)
    d = torch.sqrt(torch.abs(best) + 1e-5)
    return divide_no_nan(torch.sum(d * valid_a, dim=1), torch.sum(valid_a, dim=1))


def symmetric_objects(vertex_counts):
    """The object indices whose eval mesh has a symmetric vertex count, from host counts [oc] or [oc, 1]."""
    counts = np.asarray(vertex_counts).reshape(-1).tolist()
    return tuple(o for o, n in enumerate(counts) if int(n) in DEFAULT_SYMMETRIC_VERTEX_COUNTS)


def evaluate_poses(
    poses,
    poses_gt,
    points_estimated,
    object_points_3d,
    object_points_3d_count,
    camera_matrixes,
    diameters,
    valid_points_filter,
    allowed_error_2d=5.0,
    symmetric_mask=None,
    symmetric_objects=None,
):
    """Batched pose evaluation.

    Args:
      poses: [b, oc, 3, 4] estimated poses (all zero = missed).
      poses_gt: [b, oc, ic, 3, 4].
      points_estimated: [b, oc, vn, 2], unused (kept for the JAX signature).
      object_points_3d: [b, oc, ic, V, 3] padded eval vertices.
      object_points_3d_count: [b, oc, ic] valid-vertex counts.
      camera_matrixes: [b, 3, 3].
      diameters: [b, oc, ic, 1].
      valid_points_filter: [b, oc] int (GT object present).
      symmetric_mask: optional [b, oc] bool; default: the vertex-count rule.
      symmetric_objects: optional tuple of the symmetric object indices, known
        on the host (``symmetric_mask`` is then ignored): ADD-S on their rows
        only. Without it ADD-S runs on every row.
    Returns:
      (err_2d, err_3d, valid_2d, valid_3d, missing, valid_count, false_pos),
      each float32 [oc], summed over the batch.
    """
    del points_estimated
    with f32_precision():
        b, oc, _, V, _ = object_points_3d.shape
        M = b * oc
        poses_f = poses.reshape(M, 3, 4)
        poses_gt_f = poses_gt[:, :, 0].reshape(M, 3, 4)
        pts3d = object_points_3d[:, :, 0].reshape(M, V, 3)
        counts = object_points_3d_count[:, :, 0].reshape(M)
        K = camera_matrixes[:, None].expand(b, oc, 3, 3).reshape(M, 3, 3)
        diam = diameters[:, :, 0, 0].reshape(M)
        filt = valid_points_filter.reshape(M)

        vvalid = torch.arange(V, device=counts.device)[None, :] < counts[:, None]
        vvalid_f = vvalid.to(poses.dtype)

        has_pose = torch.abs(torch.sum(poses_f.reshape(M, -1), dim=1)) > 1e-4
        gt_present = filt != 0
        fp = (~gt_present) & has_pose
        missing = gt_present & (~has_pose)
        active = gt_present & has_pose

        cam_est = pts3d @ poses_f[:, :, :3].transpose(1, 2) + poses_f[:, None, :, 3]
        cam_gt = pts3d @ poses_gt_f[:, :, :3].transpose(1, 2) + poses_gt_f[:, None, :, 3]
        uv_est = cam_est @ K.transpose(1, 2)
        uv_gt = cam_gt @ K.transpose(1, 2)
        xy_est = divide_no_nan(uv_est[..., :2], uv_est[..., 2:])
        xy_gt = divide_no_nan(uv_gt[..., :2], uv_gt[..., 2:])

        n_valid = torch.sum(vvalid_f, dim=1)
        err_2d = divide_no_nan(torch.sum(torch.linalg.vector_norm(xy_gt - xy_est, dim=-1) * vvalid_f, dim=1), n_valid)
        add = divide_no_nan(torch.sum(torch.linalg.vector_norm(cam_gt - cam_est, dim=-1) * vvalid_f, dim=1), n_valid)

        if symmetric_objects is not None:
            sym_obj = sorted(set(symmetric_objects))

            def rows(x):  # [M, ...] -> the symmetric objects' rows [b * len(sym_obj), ...], by static slices
                x = x.reshape(b, oc, *x.shape[1:])
                return torch.cat([x[:, o : o + 1] for o in sym_obj], dim=1).reshape(-1, *x.shape[2:])

            err_3d = add
            if sym_obj:
                adds = _closest_point_mean(rows(cam_gt), rows(cam_est), rows(vvalid_f), rows(vvalid)).reshape(b, -1)
                cols = dict(zip(sym_obj, adds.unbind(1)))
                err_3d = torch.stack([cols.get(o, col) for o, col in enumerate(add.reshape(b, oc).unbind(1))],
                                     dim=1).reshape(M)
        else:
            if symmetric_mask is None:
                sym = torch.zeros_like(counts, dtype=torch.bool)
                for c in DEFAULT_SYMMETRIC_VERTEX_COUNTS:
                    sym = sym | (counts == c)
            else:
                sym = symmetric_mask.reshape(M)
            err_3d = torch.where(sym, _closest_point_mean(cam_gt, cam_est, vvalid_f, vvalid), add)

        valid_3d = (err_3d < diam * 0.1) & active
        valid_2d = (err_2d < allowed_error_2d) & active
        zero = torch.zeros_like(err_2d)
        err_2d = torch.where(active, err_2d, torch.where(missing, torch.full_like(zero, 99.9), zero))
        err_3d = torch.where(active, err_3d, torch.where(missing, torch.full_like(zero, 999.9), zero))

        def col(x):
            return torch.sum(x.reshape(b, oc).to(torch.float32), dim=0)

        return (col(err_2d), col(err_3d), col(valid_2d), col(valid_3d), col(missing), col(gt_present), col(fp))
