"""Training and evaluation losses, differentiable as the JAX package's.

Counterpart of ``casapose_tpu/losses/losses.py``: masked smooth-L1 on the
direction fields, the proxy voting loss and its per-object distances, the
keypoint reprojection loss (with differentiable pose estimation through
``pose/bpnp.py``) and the composite loss of the train / test scripts. Every
``stop_gradient`` of the JAX functions is a ``.detach()`` here, the
zero-safe helpers double-``where`` their operand, and the norms take
sqrt(sum(x^2)) as JAX does, so gradients agree where the JAX ones are
finite (tests/test_torch_train_grads.py).
"""

import dataclasses

import torch

from casapose_tpu_torch.core.numerics import divide_no_nan
from casapose_tpu_torch.parallel.mesh import all_reduce_sum
from casapose_tpu_torch.pose.bpnp import bpnp_pose
from casapose_tpu_torch.pose.geometry import project_batch, rodrigues, transform_points_back_batch


@dataclasses.dataclass(frozen=True)
class LossWeights:
    """Loss weights and filters."""

    mask_loss_weight: float = 1.0
    vertex_loss_weight: float = 0.5
    proxy_loss_weight: float = 0.015
    kp_loss_weight: float = 0.007
    filter_vertex_with_segmentation: bool = False
    filter_high_proxy_errors: bool = False


def _smooth_l1(x):
    ax = torch.abs(x)
    return torch.where(ax < 1.0, 0.5 * ax * ax, ax - 0.5)


def _safe_norm(x, dim=-1, keepdim=True, eps=1e-12):
    """L2 norm with a finite gradient at zero."""
    return torch.sqrt(torch.sum(x * x, dim=dim, keepdim=keepdim) + eps)


def smooth_l1_loss(vertex_pred, vertex_targets, vertex_weights, ignore_weights=False, invert_weights=False,
                   normalize=True, reduce=True):
    """Masked smooth-L1 on direction fields, normalised per image by ver_dim times the mask mass."""
    b = vertex_pred.shape[0]
    ver_dim = vertex_pred.shape[3]
    if ignore_weights:
        vertex_weights = torch.ones_like(vertex_weights)
    elif invert_weights:
        vertex_weights = torch.abs(1.0 - vertex_weights)
    in_loss = _smooth_l1(vertex_weights * (vertex_pred - vertex_targets))
    if normalize:
        in_loss = torch.sum(in_loss.reshape(b, -1), dim=1) / (ver_dim * torch.sum(vertex_weights.reshape(b, -1), dim=1) + 1e-3)
    if reduce:
        in_loss = torch.mean(in_loss)
    return in_loss


def _proxy_perp_foot_dist(vertex_pred, keypoint_targets, vertex_one_hot_weights, vertex_weights):
    """Per-pixel distance of each predicted line to its GT keypoint.

    Args:
      vertex_pred: [b, h, w, vn * 2] predicted (dy, dx) directions.
      keypoint_targets: [b, oc, ic, vn, 2] GT keypoints (y, x).
      vertex_one_hot_weights: [b, h, w, oc] per-object one-hot foreground.
      vertex_weights: [b, h, w, 1] foreground mask (already inverted).
    Returns: dist [b, h, w, vn] (zero on background), argmax object map [b, h, w].
    """
    b, h, w, ver_dim = vertex_pred.shape
    vn = ver_dim // 2
    oc = vertex_one_hot_weights.shape[-1]
    ic = keypoint_targets.shape[2]
    obj_idx = torch.argmax(vertex_one_hot_weights, dim=-1)
    onehot = (obj_idx[..., None] == torch.arange(oc, device=obj_idx.device)).to(vertex_pred.dtype)
    kp = torch.einsum("bhwc,bcf->bhwf", onehot, keypoint_targets.reshape(b, oc, ic * vn * 2)).reshape(b, h, w, ic, vn, 2)
    kp_cross = torch.cat([kp[..., 1:2], -kp[..., 0:1]], dim=-1)  # (x, -y)

    v = vertex_pred.reshape(b, h, w, vn, 2)
    v_norm = torch.sqrt(torch.sum(v * v, dim=4))[:, :, :, None]  # [b, h, w, 1, vn]
    c_x = (torch.arange(w, dtype=vertex_pred.dtype, device=v.device) + 0.5).view(1, 1, w, 1)
    c_y = (torch.arange(h, dtype=vertex_pred.dtype, device=v.device) + 0.5).view(1, h, 1, 1)
    d_2 = (v[..., 0] * (-c_x) + v[..., 1] * c_y)[:, :, :, None]
    d_1 = torch.sum(v[:, :, :, None] * kp_cross, dim=5)  # [b, h, w, ic, vn]
    dist = torch.amin(divide_no_nan(torch.abs(d_1 + d_2), v_norm), dim=3)
    return torch.abs(vertex_weights * dist), obj_idx


def _gather_separated_fields(vertex_pred, vertex_one_hot_weights, vertex_weights, oc, vn):
    """pvnet-style fields: each pixel's own-class field, zero on background."""
    b, h, w, _ = vertex_pred.shape
    vp = vertex_pred.reshape(b, h, w, oc, vn * 2)
    obj_idx = torch.argmax(vertex_one_hot_weights, dim=3)
    onehot = (obj_idx[..., None] == torch.arange(oc, device=obj_idx.device)).to(vertex_pred.dtype)
    vp = torch.einsum("bhwc,bhwcf->bhwf", onehot, vp)
    return torch.where(vertex_weights > 0, torch.zeros_like(vp), vp)


def proxy_voting_dist(vertex_pred, keypoint_targets, vertex_one_hot_weights, vertex_weights, invert_weights=False,
                      min_object_pixel=20):
    """Per-pixel proxy distances and per-object normalised losses: (dist [b, h, w, vn], per-object [b, oc])."""
    ver_dim = vertex_pred.shape[3]
    oc = vertex_one_hot_weights.shape[3]
    vn = keypoint_targets.shape[3]
    if oc > 1 and ver_dim == oc * vn * 2:
        vertex_pred = _gather_separated_fields(vertex_pred, vertex_one_hot_weights, vertex_weights, oc, vn)
        ver_dim = vn * 2
    if invert_weights:
        vertex_weights = torch.abs(1.0 - vertex_weights)
    dist, _ = _proxy_perp_foot_dist(vertex_pred, keypoint_targets, vertex_one_hot_weights, vertex_weights)
    mask_sum = torch.sum(vertex_one_hot_weights, dim=(1, 2))  # [b, oc]
    valid = (mask_sum >= min_object_pixel).to(dist.dtype)
    in_loss = torch.sum(_smooth_l1(dist), dim=-1)  # [b, h, w]
    per_object = torch.einsum("bhw,bhwo->bo", in_loss, vertex_one_hot_weights)
    per_object = divide_no_nan(valid * per_object, (ver_dim / 2) * mask_sum + 1e-3)
    return dist, per_object


def proxy_voting_loss(vertex_pred, keypoint_targets, vertex_one_hot_weights, vertex_weights, invert_weights=False,
                      normalize=True, reduce=True, loss_per_object=False, min_object_pixel=20):
    """PVNet proxy voting loss: smooth-L1 of the perpendicular-foot distances."""
    b, _, _, ver_dim = vertex_pred.shape
    if invert_weights:
        vertex_weights = torch.abs(1.0 - vertex_weights)
    dist, _ = _proxy_perp_foot_dist(vertex_pred, keypoint_targets, vertex_one_hot_weights, vertex_weights)
    if loss_per_object and normalize:
        mask_sum = torch.sum(vertex_one_hot_weights, dim=(1, 2))
        valid = (mask_sum >= min_object_pixel).to(dist.dtype)
        count = torch.sum(valid != 0, dim=1)
        in_loss = torch.sum(_smooth_l1(dist), dim=-1)
        per_object = torch.einsum("bhw,bhwo->bo", in_loss, vertex_one_hot_weights)
        per_object = divide_no_nan(valid * per_object, ver_dim * mask_sum + 1e-3)
        in_loss = divide_no_nan(torch.sum(per_object, dim=1), count.to(vertex_pred.dtype))
    else:
        in_loss = _smooth_l1(dist)
        if normalize:
            in_loss = torch.sum(in_loss.reshape(b, -1), dim=1) / (
                ver_dim * torch.sum(vertex_weights.reshape(b, -1), dim=1) + 1e-3
            )
    if reduce:
        in_loss = torch.mean(in_loss)
    return in_loss


def keypoint_reprojection_loss(
    points_estimated,
    seg_estimated,
    poses_gt,
    object_points_3d,
    target_seg,
    camera_data,
    offsets,
    confidence,
    max_pixel_error=25.0,
    confidence_regularization=False,
    min_num=20,
    min_num_gt=-1,
    use_bpnp_reprojection_loss=False,
    estimate_poses=False,
    filter_with_gt=True,
    data_parallel=None,
):
    """Smooth-L1 between the voted keypoints and their GT-pose reprojections, with optional pose estimation.

    Args:
      points_estimated: [b, oc, vc, 2] voted keypoints (y, x) pixels.
      seg_estimated: [b, h, w, 1 + oc] segmentation logits.
      poses_gt: [b, oc, ic, 3, 4].
      object_points_3d: [b, oc, ic, vc, 3].
      target_seg: [b, h, w, 1 + oc] one-hot GT segmentation.
      camera_data: [b, 3, 3]; element 0 is used (shared intrinsics).
      offsets: [b, 10] loader offsets.
      confidence: [b, h, w, vc] raw confidences (pre-softplus).
      data_parallel: a ``parallel/mesh.py::DataParallel``, each rank with its rows of the global batch: the loss is normalised by the
        global count of available objects and scaled by the rank count, so
        that the mean over the ranks (what DDP's gradient averaging
        differentiates, and what the trainer logs) is the global batch's loss.
    Returns:
      (loss, poses_est [b, oc, ic, 3, 4] or None, points [b, oc, vc, 2] in
      original-image (x, y) pixels).
    """
    b = target_seg.shape[0]
    _, oc, ic, _, _ = poses_gt.shape
    vc = object_points_3d.shape[3]
    dtype = points_estimated.dtype

    offsets_b = offsets[:, None].expand(b, oc, 10).reshape(-1, 10)
    pts = points_estimated.reshape(-1, vc, 2).flip(-1)  # (y, x) -> (x, y)
    object_points_3d = object_points_3d.reshape(-1, vc, 3).detach()
    poses_gt = poses_gt.reshape(-1, 3, 4)

    est_labels = torch.argmax(seg_estimated.detach(), dim=-1)
    px_gt = torch.sum(target_seg[:, :, :, 1:] != 0, dim=(1, 2))  # [b, oc]
    px_est = torch.sum(est_labels[..., None] == torch.arange(1, oc + 1, device=est_labels.device), dim=(1, 2))
    available = (px_est > min_num).to(torch.int64)
    if filter_with_gt:
        thresh_gt = min_num if min_num_gt < 0 else min_num_gt
        available = available * (px_gt > thresh_gt).to(torch.int64)
    available = available.reshape(-1, 1)[:, None].to(dtype)  # [b * oc, 1, 1]

    confidence_loss = 0.0
    if confidence_regularization:
        conf = torch.logaddexp(confidence, torch.zeros_like(confidence))
        fg = torch.abs(target_seg[:, :, :, 0:1] - 1.0)
        conf_sum = torch.sum(conf * fg, dim=(1, 2), keepdim=True)
        fg_sum = torch.sum(fg, dim=(1, 2, 3), keepdim=True)
        confidence_loss = torch.mean(torch.abs(divide_no_nan(conf_sum, fg_sum) - 0.7))

    col = lambda i: offsets_b[:, i : i + 1]  # noqa: E731
    pts = transform_points_back_batch(pts, col(0), col(1), col(8), col(9), col(4), col(5), col(6), col(7))
    cam = camera_data[0].detach()

    poses_est = None
    if use_bpnp_reprojection_loss or estimate_poses:
        p6d = bpnp_pose(pts, object_points_3d, cam)
        T_out = p6d[:, 3:6][..., None]
        poses_flat = torch.cat([rodrigues(p6d[:, 0:3]), T_out], dim=-1)
        poses_flat = torch.where(T_out[:, 2:3, :] < 0, -poses_flat, poses_flat)
        reproj_est = project_batch(object_points_3d, cam, poses_flat)[0] * available
        poses_est = (poses_flat * available).reshape(b, oc, ic, 3, 4)

    reproj_gt = project_batch(object_points_3d, cam, poses_gt)[0] * available
    pts = pts * available
    if use_bpnp_reprojection_loss:
        loss = (_safe_norm(reproj_est - pts) + _safe_norm(reproj_gt - reproj_est)) / 2.0
    else:
        loss = _safe_norm(reproj_gt - pts)
    loss = _smooth_l1(loss)
    loss = torch.where(loss > max_pixel_error, max_pixel_error + (loss - max_pixel_error) * 0.01, loss)
    loss = torch.mean(loss * available, dim=(1, 2))  # [b * oc]
    # Over the global count of available objects; times the ranks, since DDP averages the ranks' gradients.
    ws = 1 if data_parallel is None else data_parallel.world_size
    loss = divide_no_nan(torch.sum(loss) * ws, all_reduce_sum(torch.sum(available), data_parallel))
    if confidence_regularization:
        loss = loss + confidence_loss
    return loss, poses_est, pts.reshape(b, oc, vc, 2)


def composite_loss(output_seg, target_seg, output_vert, target_vert, target_points, loss_weights, filtered_seg=None,
                   pixel_gt_count=None, kp_loss=None):
    """[loss, mask_loss, vertex_loss, proxy_loss, kp_loss] with loss = w_m mask + w_v vertex + w_p proxy + w_k kp.

    The mask loss is softmax cross entropy with the one-hot target;
    ``filter_vertex_with_segmentation`` replaces the vertex-loss target where
    the prediction disagrees, ``filter_high_proxy_errors`` drops objects with
    a proxy error of 5 or more.
    """
    oc = target_seg.shape[3] - 1
    vn = target_points.shape[3]
    vc = vn * 2
    dtype = output_seg.dtype
    zero = torch.zeros((), dtype=dtype, device=output_seg.device)
    mask_loss = vertex_loss = proxy_loss = zero
    separated = oc > 1 and output_vert.shape[-1] == oc * vc
    bg = (torch.arange(oc + 1, device=output_seg.device) == 0).to(dtype)  # (1, 0, ..., 0), made on the device

    if loss_weights.mask_loss_weight > 0.0:
        shifted = output_seg - torch.amax(output_seg, dim=-1, keepdim=True).detach()
        log_z = torch.log(torch.sum(torch.exp(shifted), dim=-1, keepdim=True))
        mask_loss = torch.mean(torch.sum(target_seg * (log_z - shifted), dim=-1))

    if filtered_seg is not None:
        labels = filtered_seg[..., 0].to(torch.int64)
        target_seg = (labels[..., None] == torch.arange(oc + 1, device=labels.device)).to(dtype)
    if loss_weights.filter_vertex_with_segmentation:
        agree = torch.argmax(target_seg, -1)[..., None] == torch.argmax(output_seg, -1)[..., None]
        target_seg = torch.where(agree, target_seg, bg)
    if loss_weights.filter_high_proxy_errors and pixel_gt_count is not None:
        _, object_loss_values = proxy_voting_dist(
            output_vert, target_points, vertex_one_hot_weights=target_seg[:, :, :, 1:],
            vertex_weights=target_seg[:, :, :, 0:1], invert_weights=True,
        )
        keep = torch.cat([torch.ones_like(object_loss_values[:, :1]), (object_loss_values < 5).to(dtype)], dim=-1)
        cond = torch.sum(keep.detach()[:, None, None] * target_seg, dim=-1, keepdim=True) > 0
        target_seg = torch.where(cond, target_seg, bg)
    target_seg = target_seg.detach()

    if loss_weights.vertex_loss_weight > 0.0:
        if separated:
            vertex_loss = sum(
                smooth_l1_loss(output_vert[..., i * vc : (i + 1) * vc], target_vert[..., i * vc : (i + 1) * vc],
                               target_seg[..., i + 1 : i + 2])
                for i in range(oc)
            )
        else:
            vertex_loss = smooth_l1_loss(output_vert, target_vert, target_seg[..., 0:1], invert_weights=True)

    if loss_weights.proxy_loss_weight > 0.0:
        if separated:
            proxy_loss = sum(
                proxy_voting_loss(output_vert[..., i * vc : (i + 1) * vc], target_points[:, i : i + 1],
                                  vertex_one_hot_weights=target_seg[..., i + 1 : i + 2],
                                  vertex_weights=target_seg[..., i + 1 : i + 2])
                for i in range(oc)
            )
        else:
            proxy_loss = proxy_voting_loss(output_vert, target_points, vertex_one_hot_weights=target_seg[..., 1:],
                                           vertex_weights=target_seg[..., 0:1], invert_weights=True)

    if kp_loss is None:
        kp_loss = zero
    loss = (
        mask_loss * loss_weights.mask_loss_weight
        + proxy_loss * loss_weights.proxy_loss_weight
        + vertex_loss * loss_weights.vertex_loss_weight
        + kp_loss * loss_weights.kp_loss_weight
    )
    return [loss, mask_loss, vertex_loss, proxy_loss, kp_loss]
