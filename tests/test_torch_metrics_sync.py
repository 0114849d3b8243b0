"""ADD-S without a host read: ``evaluate_poses`` of the port against the JAX package's, on the CPU.

The eval step knows on the host which objects are symmetric (their eval
meshes' vertex counts, ``symmetric_objects``) and hands them to
``evaluate_poses`` as a static index: ADD-S then runs on those objects'
rows only. A ``symmetric_mask`` tensor, or the vertex-count rule without the
index, computes ADD-S on every row and selects afterwards, as JAX does. All
of them are held against JAX's ``evaluate_poses`` at tests/test_torch_eval.py's
tolerances (counts exactly; 2D error sums rtol 1e-5, atol 1e-4 px; 3D error
sums rtol 1e-5, atol 1e-6 m: ADD-S's minimum runs over other tiles). While
the port's metrics run, any read of a tensor's value on the host
(``nonzero``, ``item``, ``tolist``, ``bool``) raises.
"""

import contextlib

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from tests.torch_parity import single_torch_thread  # noqa: F401 (autouse)

CAM = np.array([[572.4, 0.0, 325.3], [0.0, 573.5, 242.0], [0.0, 0.0, 1.0]], np.float32)
B, OC, V = 2, 3, 3600
COUNTS = {"none": (V, V - 7, V - 100), "all": (3417, 3417, 3417), "some": (3417, V - 7, 3417)}


def _case(per_object_counts, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-0.05, 0.05, (B, OC, 1, V, 3)).astype(np.float32)
    counts = np.broadcast_to(np.asarray(per_object_counts, np.int32)[None, :, None], (B, OC, 1)).copy()
    poses_gt = np.zeros((B, OC, 1, 3, 4), np.float32)
    poses_gt[:, :, 0, :, :3] = Rotation.random(B * OC, random_state=3).as_matrix().reshape(B, OC, 3, 3)
    poses_gt[:, :, 0, :, 3] = [0.05, -0.02, 0.9]
    poses = poses_gt[:, :, 0].copy()
    poses[..., :3] = np.einsum("boij,bojk->boik", Rotation.from_rotvec(rng.normal(scale=0.05, size=(B * OC, 3)))
                               .as_matrix().reshape(B, OC, 3, 3).astype(np.float32), poses[..., :3])
    poses[..., 3] += rng.normal(scale=0.01, size=(B, OC, 3)).astype(np.float32)
    poses[1, 2] = 0.0  # missed
    filt = np.ones((B, OC), np.int32)
    filt[0, 1] = 0  # false positive
    diam = np.full((B, OC, 1, 1), 0.1, np.float32)
    cams = np.broadcast_to(CAM, (B, 3, 3)).copy()
    return poses, poses_gt, np.zeros((B, OC, 9, 2), np.float32), pts, counts, cams, diam, filt


@contextlib.contextmanager
def _no_host_reads():
    def refuse(*_, **__):
        raise AssertionError("a tensor's value was read on the host")

    saved = {name: getattr(torch.Tensor, name) for name in ("nonzero", "item", "tolist", "__bool__")}
    nonzero = torch.nonzero
    for name in saved:
        setattr(torch.Tensor, name, refuse)
    torch.nonzero = refuse
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)
        torch.nonzero = nonzero


def _compare(got, want):
    got = [x.numpy() for x in got]
    want = [np.asarray(x) for x in want]
    for i in (2, 3, 4, 5, 6):  # valid_2d, valid_3d, missing, valid_count, false_pos: counts
        np.testing.assert_array_equal(got[i], want[i])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-4)  # 2D error sums, px
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-6)  # 3D error sums, m
    return got


@pytest.mark.parametrize("which", list(COUNTS))
@pytest.mark.parametrize("static", [True, False])
def test_static_symmetric_index_matches_jax(which, static):
    from casapose_tpu.pose.metrics import evaluate_poses as jax_evaluate

    from casapose_tpu_torch.pose.metrics import evaluate_poses, symmetric_objects

    args = _case(COUNTS[which])
    sym = symmetric_objects(np.asarray(COUNTS[which])[:, None])
    assert sym == {"none": (), "all": (0, 1, 2), "some": (0, 2)}[which]
    want = jax_evaluate(*args, 5.0)
    with _no_host_reads():
        got = evaluate_poses(*(torch.from_numpy(a) for a in args), 5.0, symmetric_objects=sym if static else None)
    got = _compare(got, want)
    if which != "none":  # ADD-S moved the 3D error sums off ADD's
        add_only = evaluate_poses(*(torch.from_numpy(a) for a in args), 5.0, symmetric_objects=())
        assert not np.allclose(add_only[1].numpy(), got[1], rtol=1e-3)


def test_symmetric_mask_tensor_every_row_matches_jax():
    from casapose_tpu.pose.metrics import evaluate_poses as jax_evaluate

    from casapose_tpu_torch.pose.metrics import evaluate_poses

    args = _case(COUNTS["none"], seed=1)
    mask = np.array([[True, False, True], [False, True, True]])
    want = jax_evaluate(*args, 5.0, symmetric_mask=mask)
    with _no_host_reads():
        got = evaluate_poses(*(torch.from_numpy(a) for a in args), 5.0, symmetric_mask=torch.from_numpy(mask))
    _compare(got, want)


def test_eval_step_hands_the_mesh_counts_as_a_static_index(monkeypatch):
    """``evaluate_pose_estimates`` passes the index on; without eval meshes no object is symmetric."""
    import casapose_tpu_torch.pose.evaluation as ev

    seen = []
    real = ev.evaluate_poses

    def spy(*args, **kwargs):
        seen.append(kwargs.get("symmetric_objects"))
        return real(*args, **kwargs)

    monkeypatch.setattr(ev, "evaluate_poses", spy)
    poses, poses_gt, pts2d, pts, counts, cams, diam, _ = _case(COUNTS["some"])
    seg = np.zeros((B, 8, 8, 1 + OC), np.float32)
    seg[:, :, :, 1:] = 1.0
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    common = (t(pts2d), t(poses), t(poses_gt), t(seg), t(pts[:, :, :, :9]), t(cams), t(diam))
    with_meshes, _, _ = ev.evaluate_pose_estimates(*common, evaluation_points=t(pts[0, :, 0]),
                                                   object_points_3d_count=t(counts[0]), min_num=1,
                                                   symmetric_objects=(0, 2))
    every_row, _, _ = ev.evaluate_pose_estimates(*common, evaluation_points=t(pts[0, :, 0]),
                                                 object_points_3d_count=t(counts[0]), min_num=1)
    ev.evaluate_pose_estimates(*common, min_num=1)
    assert seen == [(0, 2), None, ()]
    for a, b in zip(with_meshes, every_row):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=0.0)
