"""The port's visual dumps against the JAX package's: the same files, pixel for pixel, on the CPU.

``casapose_tpu_torch/utils/visualization.py`` is a copy of the JAX
package's numpy/PIL writers with the port's geometry; each writer runs in
both packages on the same seeded arrays into two directories, and every
PNG written must exist in both with equal pixels. The eval harness's
``--save_eval_batches`` and the trainer's ``--save_debug_batch`` call these
writers (tests/test_torch_profile.py and tests/test_torch_train_resume.py
run the options).
"""

import os

import numpy as np
import pytest
from PIL import Image

OC, K, H, W = 2, 3, 48, 64


def _images(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            out[os.path.relpath(path, root)] = np.asarray(Image.open(path))
    return out


def _assert_same_dumps(a, b):
    ia, ib = _images(a), _images(b)
    assert ia and sorted(ia) == sorted(ib)
    for name in ia:
        np.testing.assert_array_equal(ia[name], ib[name], err_msg=name)


def _poses(rng, b):
    """[b, oc, 3, 4] poses in front of a 60-px-focal camera, one object of the first image absent (all zero)."""
    from scipy.spatial.transform import Rotation

    R = Rotation.random(b * OC, random_state=3).as_matrix().reshape(b, OC, 3, 3)
    t = np.stack([rng.uniform(-0.05, 0.05, (b, OC)), rng.uniform(-0.05, 0.05, (b, OC)),
                  rng.uniform(0.5, 0.8, (b, OC))], -1)
    poses = np.concatenate([R, t[..., None]], -1).astype(np.float32)
    poses[0, 1] = 0.0
    return poses


@pytest.fixture(scope="module")
def arrays():
    rng = np.random.default_rng(0)
    b = 2
    cam = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]], np.float32)
    corners = np.array([[x, y, z] for x in (-0.03, 0.03) for y in (-0.03, 0.03) for z in (-0.03, 0.03)], np.float32)
    return {
        "img_u8": rng.integers(0, 256, (b, H, W, 3)).astype(np.uint8),
        "img": rng.uniform(-1, 1, (b, H, W, 3)).astype(np.float32),
        "seg": rng.integers(0, OC + 1, (b, H, W, 1)).astype(np.uint8),
        "output_seg": rng.normal(size=(b, H, W, OC + 1)).astype(np.float32),
        "dirs": rng.normal(size=(b, H, W, 2 * K)).astype(np.float32),
        "target_dirs": rng.normal(size=(b, H, W, 2 * K)).astype(np.float32),
        "confidence": rng.normal(size=(b, H, W, K)).astype(np.float32),
        "poses": _poses(rng, b),
        "poses_gt": _poses(np.random.default_rng(1), b)[:, :, None],
        "points": rng.uniform(0, W, (b, OC, K, 2)).astype(np.float32),
        "camera": np.broadcast_to(cam, (b, 3, 3)).copy(),
        "cuboid3d": np.broadcast_to(corners, (b, OC, 1, 8, 3)).copy(),
        "keypoints3d": rng.uniform(-0.03, 0.03, (b, OC, 1, K, 3)).astype(np.float32),
        "offsets": np.array([[0, 0, H, W, 2.0, -1.0, 5.0, 1.0, W, H]] * b, np.float32),
        "proxy_dist": rng.uniform(0, 20, (b, H, W, K)).astype(np.float32),
        "proxy_per_object": np.array([[1.0, 7.0], [4.0, 6.0]], np.float32),
        "image_id": np.array([[b"000000/000001"], [b"000000/000002"]]),
    }


def _both(tmp_path, call):
    """Run ``call(visualization module, out_dir)`` with the JAX package's and the port's modules."""
    import casapose_tpu.utils.visualization as jv
    import casapose_tpu_torch.utils.visualization as pv

    for mod, d in ((jv, "jax"), (pv, "port")):
        call(mod, str(tmp_path / d))
    _assert_same_dumps(tmp_path / "jax", tmp_path / "port")


def test_save_batches(tmp_path, arrays):
    class Iterator:
        def get_next(self):
            return {"img": arrays["img_u8"], "seg": arrays["seg"]}

    _both(tmp_path, lambda mod, d: mod.save_batches(Iterator(), d))


def test_save_eval_batch(tmp_path, arrays):
    a = arrays
    batch = {"img": a["img_u8"], "camera": a["camera"], "cuboid3d": a["cuboid3d"]}
    _both(tmp_path, lambda mod, d: mod.save_eval_batch(
        batch, a["output_seg"], a["target_dirs"], a["dirs"], a["poses"], a["points"], OC, K, path_out=d,
        confidence=a["confidence"], add_correct=np.array([1.0, 0.0]), batch_idx=3))


@pytest.mark.parametrize("split", [False, True])
def test_save_pose_comparison(tmp_path, arrays, split):
    a = arrays
    for i in range(2):
        _both(tmp_path, lambda mod, d: mod.save_pose_comparison(
            a["img"][i], a["poses"][i], a["poses_gt"][i], a["cuboid3d"][i], a["keypoints3d"][i], a["camera"][i],
            a["offsets"][i], path_out=os.path.join(d, str(i)), add_correct=np.array([1.0, 0.0]),
            draw_reprojection=True, split_by_no_correct=split))


def test_save_proxy_error_maps_and_mask(tmp_path, arrays):
    a = arrays
    tseg = np.eye(OC + 1, dtype=np.float32)[a["seg"][..., 0]]

    def call(mod, d):
        for i in range(2):
            mod.save_proxy_error_maps(a["proxy_dist"][i], tseg[i], os.path.join(d, str(i)), no_features=K)
            mod.save_mask_by_proxy_loss(a["proxy_per_object"][i], tseg[i], os.path.join(d, str(i)))

    _both(tmp_path, call)


def test_geometry_helpers_match(arrays):
    from casapose_tpu.pose.geometry import apply_offsets_np as jax_offsets
    from casapose_tpu.pose.geometry import project_np as jax_project
    from casapose_tpu_torch.pose.geometry import apply_offsets_np, project_np

    a = arrays
    pose = a["poses"][0, 0]
    for got, want in zip(project_np(a["keypoints3d"][0, 0, 0], a["camera"][0], pose),
                         jax_project(a["keypoints3d"][0, 0, 0], a["camera"][0], pose)):
        np.testing.assert_array_equal(got, want)
    pts = a["points"][0, 0]
    np.testing.assert_array_equal(apply_offsets_np(pts, a["offsets"][0]), jax_offsets(pts, a["offsets"][0]))


def test_points_beyond_the_int32_range_are_clipped():
    """A cuboid corner just in front of the camera projects beyond cv2's int32 range: the JAX writer raises there;
    the port's draws what the JAX writer draws from the clipped points, and skips non-finite ones."""
    import cv2

    import casapose_tpu.utils.visualization as jv
    import casapose_tpu_torch.utils.visualization as pv

    img = np.zeros((H, W, 3), np.uint8)
    corners = np.random.default_rng(4).uniform(5, 40, (8, 2))
    corners[3] = (3e12, -7e11)
    with pytest.raises(cv2.error):
        jv.draw_bbox(img.copy(), corners)
    got = pv.draw_bbox(img.copy(), corners)
    np.testing.assert_array_equal(got, jv.draw_bbox(img.copy(), np.clip(corners, -(2**31), 2**31 - 1)))
    assert got.any()
    corners[5] = np.nan
    np.testing.assert_array_equal(pv.draw_bbox(img.copy(), corners), img)
