"""Pose solve and evaluation glue: counterpart of ``casapose_tpu/pose/evaluation.py``.

``poses_pnp`` (the inference step's pose solve), ``estimate_poses`` (PnP on
voted points with the loader's offsets undone) and
``evaluate_pose_estimates`` (the LS-voting evaluation: poses come from the
keypoint loss, metrics from ``pose/metrics.py``) and
``estimate_and_evaluate_poses`` (the RANSAC evaluation of the
``estimate_coords 0`` models: voting in ``pose/ransac.py``, then PnP and the
metrics).
"""

import torch

from casapose_tpu_torch.pose.epnp import pose_matrix_from_p6d, solve_pnp
from casapose_tpu_torch.pose.geometry import transform_points_back_batch
from casapose_tpu_torch.pose.metrics import evaluate_poses
from casapose_tpu_torch.pose.ransac import ransac_voting_layer_all_masks


def poses_pnp(points_estimated, seg_estimated, object_points_3d, camera_data, no_objects, min_num=20):
    """Poses from voted keypoints.

    Args:
      points_estimated: [b, oc, k, 2] voted keypoints, (y, x).
      seg_estimated: [b, h, w, 1+oc] segmentation logits.
      object_points_3d: [b, oc, 1, k, 3] model keypoints.
      camera_data: [b, 3, 3] intrinsics; the first is used for the batch.
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
    poses = pose_matrix_from_p6d(solve_pnp(pts, pts3d, camera_data[0])) * available
    return poses.reshape(b, oc, 1, 3, 4)


def _tile_eval_points(evaluation_points, object_points_3d_count, b, ic):
    """[oc, V, 3] and [oc, 1] -> [b, oc, ic, V, 3] and [b, oc, ic]."""
    return evaluation_points[None, :, None].expand(b, -1, ic, -1, -1), object_points_3d_count[None].repeat(b, 1, ic)


def estimate_poses(points, keypoints3d, camera_matrixes, valid_points_filter, offsets):
    """PnP on voted points with the loader's offsets undone.

    Args:
      points: [b, oc, vn, 2] voted points, (x, y) network pixels.
      keypoints3d: [b, oc, ic, vn, 3].
      camera_matrixes: [b, 3, 3].
      valid_points_filter: [b, oc] int.
      offsets: [b, 10].
    Returns: (poses [b, oc, 3, 4], false_positive [oc]).
    """
    b, oc, _, vn, _ = keypoints3d.shape
    pts = points.reshape(-1, vn, 2)
    filt = valid_points_filter.reshape(-1)
    off = offsets[:, None].expand(b, oc, 10).reshape(-1, 10)
    nonzero = torch.abs(torch.sum(pts.reshape(b * oc, -1), dim=1)) >= 0.01
    false_positive = torch.sum(((filt == 0) & nonzero).to(torch.float32).reshape(b, oc), dim=0)
    col = lambda i: off[:, i : i + 1]  # noqa: E731
    mapped = transform_points_back_batch(pts, col(0), col(1), col(8), col(9), col(4), col(5), col(6), col(7))
    mapped = torch.where(nonzero[:, None, None], mapped, torch.zeros_like(mapped))
    p6d = solve_pnp(mapped, keypoints3d[:, :, 0].reshape(-1, vn, 3), camera_matrixes[0])
    poses = pose_matrix_from_p6d(p6d)
    poses = torch.where(nonzero[:, None, None], poses, torch.zeros_like(poses))
    return poses.reshape(b, oc, 3, 4), false_positive


def evaluate_pose_estimates(points_estimated, poses, poses_gt, target_seg, object_points_3d, camera_data, diameters,
                            evaluation_points=None, object_points_3d_count=None, min_num=20, symmetric_objects=None):
    """LS-voting evaluation: the poses were estimated inside the keypoint loss.

    ``symmetric_objects``: the symmetric object indices of the eval meshes,
    known on the host (``pose/metrics.py::symmetric_objects``), so that ADD-S
    runs on their rows only; without eval meshes no object is symmetric.

    Returns ([valid_2d, valid_3d, valid_count, zeros, err_2d, err_3d,
    missing, false_positive], poses, points_estimated), each stat [oc].
    """
    b = target_seg.shape[0]
    _, oc, ic, _, _ = poses_gt.shape
    available = (torch.sum(target_seg[:, :, :, 1:] != 0, dim=(1, 2)) > min_num).to(torch.int32)
    if evaluation_points is not None and object_points_3d_count is not None:
        object_points_3d, object_points_3d_count = _tile_eval_points(evaluation_points, object_points_3d_count, b, ic)
    else:
        object_points_3d_count = torch.full((b, oc, ic), 9, dtype=torch.int32, device=poses_gt.device)
        symmetric_objects = ()  # 9 keypoints a row: no symmetric vertex count
    poses_first = poses[:, :, 0] if poses.ndim == 5 else poses
    err_2d, err_3d, valid_2d, valid_3d, missing, valid_count, false_pos = evaluate_poses(
        poses_first, poses_gt, points_estimated, object_points_3d, object_points_3d_count, camera_data, diameters,
        available, 5.0, symmetric_objects=symmetric_objects,
    )
    return (
        [valid_2d, valid_3d, valid_count, torch.zeros_like(valid_2d), err_2d, err_3d, missing, false_pos],
        poses,
        points_estimated,
    )


def estimate_and_evaluate_poses(output_seg, target_seg, output_vertex, poses_gt, object_points_3d, camera_data,
                                diameters, offsets, evaluation_points=None, object_points_3d_count=None,
                                points_estimated=None, min_num=20, ransac_rounds=1, generator=None, draws=None,
                                symmetric_objects=None):
    """RANSAC-voting evaluation (``pvnet`` and the other ``estimate_coords 0`` models).

    The argmax segmentation's class masks; for a PVNet output with one field
    stack per object ([b, h, w, oc * vc * 2]), each pixel's stack of its
    predicted class (zero on the background); RANSAC voting; PnP on the voted
    points with the loader's offsets undone; the metrics. ``generator`` and
    ``draws`` go to ``ransac_voting_layer_all_masks``; ``symmetric_objects``
    as in :func:`evaluate_pose_estimates`.

    Returns ([valid_2d, valid_3d, valid_count, false_positive_mask, err_2d,
    err_3d, missing, false_positive], poses [b, oc, 3, 4], points [b, oc, vc, 2] (x, y)).
    """
    b, h, w, c = target_seg.shape
    _, oc, ic, _, _ = poses_gt.shape
    vc = object_points_3d.shape[3]
    available = (torch.sum(target_seg[:, :, :, 1:] != 0, dim=(1, 2)) > min_num).to(torch.int32)

    argmax_seg = torch.argmax(output_seg, dim=3)
    mask_one_hot = (argmax_seg[..., None] == torch.arange(c, device=argmax_seg.device)).to(output_seg.dtype)
    if oc > 1 and output_vertex.shape[-1] == vc * oc * 2:
        ov = output_vertex.reshape(b, h, w, oc, vc, 2)
        sel = torch.clamp(argmax_seg - 1, min=0)
        ov = torch.gather(ov, 3, sel[..., None, None, None].expand(b, h, w, 1, vc, 2))[:, :, :, 0]
        output_vertex = torch.where((argmax_seg == 0)[..., None, None], torch.zeros_like(ov), ov)
    output_vertex = output_vertex.reshape(b, h, w, vc, 2)

    if points_estimated is None:
        points_estimated = ransac_voting_layer_all_masks(
            mask_one_hot[:, :, :, 1:], output_vertex, 512, inlier_thresh=0.99, max_iter=ransac_rounds,
            min_num=min_num, max_num=30000, generator=generator, draws=draws)
    else:
        scale = torch.where(torch.arange(2, device=output_seg.device) == 0, float(h), float(w))  # (h, w) on the device
        points_estimated = points_estimated * scale

    poses, false_positive_mask = estimate_poses(points_estimated, object_points_3d, camera_data, available, offsets)
    if evaluation_points is not None and object_points_3d_count is not None:
        object_points_3d, object_points_3d_count = _tile_eval_points(evaluation_points, object_points_3d_count, b, ic)
    else:
        object_points_3d_count = torch.full((b, oc, ic), 9, dtype=torch.int32, device=poses_gt.device)
        symmetric_objects = ()
    err_2d, err_3d, valid_2d, valid_3d, missing, valid_count, false_pos = evaluate_poses(
        poses, poses_gt, points_estimated, object_points_3d, object_points_3d_count, camera_data, diameters,
        available, 5.0, symmetric_objects=symmetric_objects,
    )
    return (
        [valid_2d, valid_3d, valid_count, false_positive_mask, err_2d, err_3d, missing, false_pos],
        poses,
        points_estimated,
    )
