"""Inference pose solve: ``poses_pnp``, counterpart of ``casapose_tpu/pose/evaluation.py::poses_pnp``."""

import torch

from casapose_tpu_torch.pose.epnp import pose_matrix_from_p6d, solve_pnp


def poses_pnp(points_estimated, seg_estimated, object_points_3d, camera_data, no_objects, min_num=20, plain=False):
    """Poses from voted keypoints.

    Args:
      points_estimated: [b, oc, k, 2] voted keypoints, (y, x).
      seg_estimated: [b, h, w, 1+oc] segmentation logits.
      object_points_3d: [b, oc, 1, k, 3] model keypoints.
      camera_data: [b, 3, 3] intrinsics; the first is used for the batch.
      plain: solve with the PnP kernel's plain version (see pose/epnp.py).
    Returns:
      [b, oc, 1, 3, 4] poses, zero where the predicted mask of an object
      has ``min_num`` pixels or fewer.
    """
    b = seg_estimated.shape[0]
    oc = no_objects
    vc = object_points_3d.shape[3]
    pts = points_estimated.reshape(-1, vc, 2).flip(-1)  # (y, x) -> (x, y)
    pts3d = object_points_3d.reshape(-1, vc, 3)
    labels = torch.argmax(seg_estimated, dim=-1)
    px_est = (labels[..., None] == torch.arange(1, oc + 1, device=labels.device)).sum(dim=(1, 2))
    available = (px_est > min_num).reshape(-1, 1, 1).to(pts.dtype)
    poses = pose_matrix_from_p6d(solve_pnp(pts, pts3d, camera_data[0], plain=plain)) * available
    return poses.reshape(b, oc, 1, 3, 4)
