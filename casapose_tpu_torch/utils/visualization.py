"""Visual debug output: input dumps, direction-field pseudocolor, overlays.

A copy of ``casapose_tpu/utils/visualization.py`` (numpy and PIL, cv2 where
it imports; the port imports nothing of the JAX package): direction maps as
HSV pseudocolor, segmentation overlays, estimated-vs-GT cuboid boxes, the
proxy-error maps. The same arrays give the same files, pixel for pixel
(tests/test_torch_visualization.py); where the JAX writers raise (a point
beyond cv2's int32 range, or not finite), the port's clip it or skip it.
The trainer's ``--save_debug_batch`` calls :func:`save_batches`; the eval harness's ``--save_eval_batches`` the
four eval writers.
"""

import os

import numpy as np
from PIL import Image

try:
    import cv2
except Exception:  # pragma: no cover
    cv2 = None

CUBOID_EDGES = [
    (0, 1), (0, 2), (1, 3), (2, 3),
    (4, 5), (4, 6), (5, 7), (6, 7),
    (0, 4), (1, 5), (2, 6), (3, 7),
]


def denormalize_image(img, normal=(0.5, 0.5)):
    """Float normalized image -> uint8."""
    out = (np.asarray(img) * normal[1] + normal[0]) * 255.0
    return np.clip(out, 0, 255).astype(np.uint8)


def direction_map_pseudocolor(dirs):
    """(dy, dx) field -> HSV pseudocolor RGB (angle = hue, magnitude = value)."""
    dy, dx = dirs[..., 0], dirs[..., 1]
    angle = (np.arctan2(dy, dx) + np.pi) / (2 * np.pi)
    mag = np.clip(np.sqrt(dy * dy + dx * dx), 0, 1)
    hsv = np.stack([angle * 179, np.full_like(angle, 255), mag * 255], axis=-1).astype(np.uint8)
    if cv2 is not None:
        return cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)
    return hsv


def _pixels(points2d):
    """Integer pixel coordinates for cv2, or None where a point is not finite.

    cv2 refuses coordinates beyond the int32 range, which a corner just in
    front of or behind the camera reaches (the JAX package's writers then
    raise); clipping to that range leaves every drawable line as it was.
    """
    pts = np.asarray(points2d, np.float64)
    if not np.isfinite(pts).all():
        return None
    return np.clip(pts, -(2**31), 2**31 - 1).astype(int)


def draw_bbox(img, points2d, color=(0, 255, 0), thickness=2):
    """Draw the 12 cuboid edges from 8 projected corners."""
    pts = _pixels(points2d)
    if cv2 is None or pts is None:
        return img
    img = np.ascontiguousarray(img)
    for a, b in CUBOID_EDGES:
        cv2.line(img, tuple(pts[a]), tuple(pts[b]), color, thickness)
    return img


def draw_points(img, points2d, color=(255, 0, 0), radius=2):
    pts = _pixels(points2d)
    if cv2 is None or pts is None:
        return img
    img = np.ascontiguousarray(img)
    for p in pts:
        cv2.circle(img, tuple(p), radius, color, -1)
    return img


def overlay_mask(img, labelmap, alpha=0.45, seed=7):
    """Colorize an integer label map over the image."""
    rng = np.random.default_rng(seed)
    n = int(labelmap.max()) + 1
    palette = rng.integers(50, 255, size=(max(n, 2), 3)).astype(np.uint8)
    palette[0] = 0
    colors = palette[labelmap.astype(int)]
    out = img.astype(np.float32)
    m = (labelmap > 0)[..., None]
    out = np.where(m, (1 - alpha) * out + alpha * colors, out)
    return out.astype(np.uint8)


def save_single_sample(path_out, idx, img, labelmap=None, dirs=None, confidence=None, normal=(0.5, 0.5)):
    """Dump one sample's image / mask overlay / direction pseudocolor."""
    os.makedirs(path_out, exist_ok=True)
    rgb = denormalize_image(img, normal) if img.dtype != np.uint8 else img
    Image.fromarray(rgb).save(os.path.join(path_out, f"{idx:04d}_img.png"))
    if labelmap is not None:
        Image.fromarray(overlay_mask(rgb, labelmap)).save(os.path.join(path_out, f"{idx:04d}_mask.png"))
    if dirs is not None:
        k2 = dirs.shape[-1]
        pc = direction_map_pseudocolor(dirs[..., 0:2].reshape(dirs.shape[:2] + (2,)))
        Image.fromarray(pc).save(os.path.join(path_out, f"{idx:04d}_dirs.png"))
    if confidence is not None:
        c = confidence[..., 0]
        c = (255 * (c - c.min()) / max(c.max() - c.min(), 1e-6)).astype(np.uint8)
        Image.fromarray(c).save(os.path.join(path_out, f"{idx:04d}_conf.png"))


def save_batches(iterator, path_out, n_batches=1, normal=(0.5, 0.5)):
    """Training-input debug dump (--save_debug_batch analogue)."""
    os.makedirs(path_out, exist_ok=True)
    for b in range(n_batches):
        batch = iterator.get_next()
        imgs = batch["img"]
        for i in range(len(imgs)):
            save_single_sample(path_out, b * len(imgs) + i, imgs[i], labelmap=batch["seg"][i, ..., 0])


def draw_match_lines(img, points_a, points_b, color=(255, 255, 0)):
    """Connect GT and estimated keypoint reprojections (draw_utils.py:60-74)."""
    pts_a, pts_b = _pixels(points_a), _pixels(points_b)
    if cv2 is None or pts_a is None or pts_b is None:
        return img
    img = np.ascontiguousarray(img)
    for a, b in zip(pts_a, pts_b):
        cv2.line(img, tuple(a), tuple(b), color, 1)
    return img


def save_pose_comparison(img, estimated_poses, gt_poses, cuboids, keypoints, camera_matrix, offsets,
                         path_out, file_prefix="", normal=(0.5, 0.5), add_correct=None,
                         draw_reprojection=True, split_by_no_correct=False):
    """Estimated-vs-GT pose renderer (dataset_utils.py:215-321).

    Writes ``cuboids.png`` — GT boxes blue, estimated boxes green when
    ADD-correct / red otherwise — and, with ``draw_reprojection``,
    ``reprojected_keypoints.png`` with GT/est keypoint reprojections and
    connecting lines. ``split_by_no_correct`` sorts images into
    ``<N>_correct/`` subfolders by the number of ADD-correct objects.

    Args:
      img: [h, w, 3] normalized float image.
      estimated_poses: [oc, 3, 4]; gt_poses: [oc, ic, 3, 4].
      cuboids: [oc, ic, 8, 3]; keypoints: [oc, ic, k, 3]; camera: [3, 3].
      offsets: [10] crop/rot/translate record (apply_offsets convention).
    """
    from casapose_tpu_torch.pose.geometry import apply_offsets_np, project_np

    if split_by_no_correct and add_correct is not None:
        path_out = os.path.join(path_out, f"{int(np.sum(add_correct))}_correct")
    os.makedirs(path_out, exist_ok=True)

    rgb = denormalize_image(img, normal)
    img_keypoints = rgb.copy()
    img_cuboids = rgb.copy()
    offsets = np.asarray(offsets)
    eps = 1e-4
    gt_color = (0, 0, 255)
    for obj_idx in range(len(np.asarray(gt_poses))):
        ok = True if add_correct is None else bool(np.asarray(add_correct)[obj_idx] > 0)
        est_color = (0, 255, 0) if ok else (255, 0, 0)
        pose_gt = np.asarray(gt_poses)[obj_idx][0]
        pose_est = np.asarray(estimated_poses)[obj_idx]
        cub = np.asarray(cuboids)[obj_idx][0]
        kps = np.asarray(keypoints)[obj_idx][0]
        valid_gt = abs(float(pose_gt.sum())) > eps
        valid_est = abs(float(pose_est.sum())) > eps

        if valid_gt:
            cub2d_gt = apply_offsets_np(project_np(cub, camera_matrix, pose_gt)[0], offsets)
            kp2d_gt = apply_offsets_np(project_np(kps, camera_matrix, pose_gt)[0], offsets)
        if valid_est:
            cub2d = apply_offsets_np(project_np(cub, camera_matrix, pose_est)[0], offsets)
            kp2d = apply_offsets_np(project_np(kps, camera_matrix, pose_est)[0], offsets)
            valid_est = abs(float(np.sum(kp2d))) > eps

        if draw_reprojection:
            if valid_gt and valid_est:
                img_keypoints = draw_match_lines(img_keypoints, kp2d_gt, kp2d)
            if valid_gt:
                img_keypoints = draw_points(img_keypoints, kp2d_gt, gt_color)
            if valid_est:
                img_keypoints = draw_points(img_keypoints, kp2d, est_color)
        if valid_gt:
            img_cuboids = draw_bbox(img_cuboids, cub2d_gt, gt_color)
        if valid_est:
            img_cuboids = draw_bbox(img_cuboids, cub2d, est_color)

    Image.fromarray(img_cuboids).save(os.path.join(path_out, file_prefix + "cuboids.png"))
    if draw_reprojection:
        Image.fromarray(img_keypoints).save(os.path.join(path_out, file_prefix + "reprojected_keypoints.png"))


def proxy_error_grayscale(dist, mask_labels, clip_max=15.0):
    """One proxy-error channel -> inverted grayscale, background zeroed
    (draw_utils.py:84-89)."""
    d = np.clip(np.asarray(dist), 0, clip_max) / clip_max * 255.0
    out = 255 - np.stack([d, d, d], axis=2).astype(np.uint8)
    out[np.asarray(mask_labels) == 0] = 0
    return out


def save_proxy_error_maps(dist, seg_onehot, path_out, file_prefix="", no_features=9, clip_max=15.0):
    """Per-keypoint clamped proxy-error dumps (dataset_utils.py:142-159)."""
    os.makedirs(path_out, exist_ok=True)
    labels = np.argmax(np.asarray(seg_onehot), axis=-1)
    dist = np.asarray(dist)
    for idx in range(min(no_features, dist.shape[-1])):
        img = proxy_error_grayscale(dist[..., idx], labels, clip_max)
        Image.fromarray(img).save(os.path.join(path_out, f"{file_prefix}proxy_error_{idx}.png"))


def save_mask_by_proxy_loss(object_loss_values, seg_onehot, path_out, file_prefix="", threshold=5.0):
    """Per-object proxy-health mask: 255 = ok, 125 = high proxy error
    (dataset_utils.py:162-176)."""
    os.makedirs(path_out, exist_ok=True)
    labels = np.argmax(np.asarray(seg_onehot), axis=-1)
    vals = np.asarray(object_loss_values).reshape(-1)
    out = np.zeros(labels.shape, np.uint8)
    for obj_idx, v in enumerate(vals, start=1):
        out[labels == obj_idx] = 125 if v > threshold else 255
    Image.fromarray(out).save(os.path.join(path_out, file_prefix + "proxy_summary.png"))


def save_eval_batch(batch, output_seg, target_dirs, output_dirs, estimated_poses, estimated_points,
                    no_objects, no_points, path_out, confidence=None, add_correct=None, batch_idx=0,
                    normal=(0.5, 0.5)):
    """Eval-time visual dump: est masks, fields, voted points, cuboids."""
    os.makedirs(path_out, exist_ok=True)
    imgs = batch["img"]
    cams = batch["camera"]
    cuboids = batch["cuboid3d"]
    for i in range(len(imgs)):
        idx = batch_idx * len(imgs) + i
        rgb = imgs[i] if imgs[i].dtype == np.uint8 else denormalize_image(imgs[i], normal)
        est_labels = np.argmax(output_seg[i], axis=-1)
        Image.fromarray(overlay_mask(rgb, est_labels)).save(os.path.join(path_out, f"{idx:04d}_est_mask.png"))
        Image.fromarray(direction_map_pseudocolor(output_dirs[i][..., 0:2])).save(
            os.path.join(path_out, f"{idx:04d}_est_dirs.png")
        )
        Image.fromarray(direction_map_pseudocolor(target_dirs[i][..., 0:2])).save(
            os.path.join(path_out, f"{idx:04d}_gt_dirs.png")
        )
        canvas = rgb.copy()
        K = cams[i]
        for o in range(no_objects):
            pose = np.asarray(estimated_poses[i, o])
            if abs(pose.sum()) < 1e-4:
                continue
            corners = np.asarray(cuboids[i, o, 0])
            cam_pts = corners @ pose[:, :3].T + pose[:, 3]
            uv = cam_pts @ np.asarray(K).T
            xy = uv[:, :2] / np.maximum(uv[:, 2:], 1e-9)
            ok = add_correct is None or (o < len(add_correct) and add_correct[o] > 0)
            canvas = draw_bbox(canvas, xy, color=(0, 255, 0) if ok else (255, 0, 0))
            if estimated_points is not None:
                canvas = draw_points(canvas, np.asarray(estimated_points[i, o]))
        Image.fromarray(canvas).save(os.path.join(path_out, f"{idx:04d}_poses.png"))
