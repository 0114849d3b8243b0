"""The port's evaluation modules and step against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances, and why:
  * geometry, direction fields, losses, metrics on the same poses: rtol
    1e-5 (atol 1e-5 to 1e-4 on values near zero): the same float32
    arithmetic in another order;
  * poses solved by PnP on planted (exact) problems: atol 1e-4, as the PnP
    tests hold the solve;
  * ADD-S: the port tiles both point sets where the JAX package tiles one,
    so the minimum runs over other blocks: rtol 1e-5;
  * the step as a whole (``build_test_step``, 64x80, 2 objects, batch 2):
    losses rtol 1e-4, metric counts exactly equal, error sums rtol 1e-4,
    poses atol 1e-4, voted points rtol 1e-4 / atol 5e-3 px (the voting
    tolerance of tests/test_voting_kernel.py).

The step's PnP problems are made well-posed: the model keypoints are put
where a random pose projects them exactly onto the voted points, seen by a
short-focal camera (f = 16 px), and the GT pose is that pose moved by
10.8 cm, so that the error sums are ~2 px and ~0.1 m (the diameter is set
to 1.5 m so that 3D-valid poses occur). With random weights and random
keypoints every problem would be ill-posed, and two float32 solvers can
stop in different minima. Even well-posed, a voted point that moves by
float32 rounding (1e-5 px) moves the solved depth by ~2e-6 m, because the
voted points of random weights lie within a few pixels of each other: the
error sums are therefore held at rtol 1e-4, also between chunked and
unchunked runs of the port.
"""

import contextlib

import numpy as np
import pytest
from scipy.spatial.transform import Rotation

from tests.torch_parity import calibrated_variables, jax_pnp_accelerator_branch

OC, K, H, W, B = 2, 9, 64, 80, 2
SEG_DIM = 1 + OC
SHORT_FOCAL = np.array([[16.0, 0.0, W / 2], [0.0, 16.0, H / 2], [0.0, 0.0, 1.0]], np.float32)
CAM = np.array([[572.4, 0.0, 325.3], [0.0, 573.5, 242.0], [0.0, 0.0, 1.0]], np.float32)


def _t(*arrays):
    import torch

    out = tuple(torch.from_numpy(np.array(a)) for a in arrays)
    return out if len(out) > 1 else out[0]


def _j(*arrays):
    import jax.numpy as jnp

    out = tuple(jnp.asarray(a) for a in arrays)
    return out if len(out) > 1 else out[0]


def _np(x):
    return x.numpy() if hasattr(x, "numpy") and not hasattr(x, "block_until_ready") else np.asarray(x)


# ----------------------------------------------------------------- geometry


@pytest.mark.parametrize("per_batch_k", [False, True])
def test_project_batch(per_batch_k):
    from casapose_tpu.pose.geometry import project_batch as jax_project
    from casapose_tpu_torch.pose.geometry import project_batch

    rng = np.random.default_rng(0)
    xyz = rng.uniform(-0.05, 0.05, (4, 9, 3)).astype(np.float32)
    RT = np.concatenate([Rotation.random(4, random_state=1).as_matrix(), rng.uniform(0.5, 1.0, (4, 3, 1))], -1).astype(np.float32)
    RT[3] = 0.0  # zero depth: divide_no_nan gives 0
    Kc = np.broadcast_to(CAM, (4, 3, 3)).copy() if per_batch_k else CAM
    want = jax_project(*_j(xyz, Kc, RT))
    got = project_batch(*_t(xyz, Kc, RT))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-5, atol=1e-4)


def test_transform_points_back_batch():
    from casapose_tpu.pose.geometry import transform_points_back_batch as jax_back
    from casapose_tpu_torch.pose.geometry import transform_points_back_batch

    rng = np.random.default_rng(1)
    pts = rng.uniform(0, 64, (5, 9, 2)).astype(np.float32)
    cols = [rng.uniform(lo, hi, (5, 1)).astype(np.float32)
            for lo, hi in ((0, 20), (0, 30), (300, 640), (200, 480), (-25, 25), (-25, 25), (-15, 15), (0.5, 2.0))]
    np.testing.assert_allclose(_np(transform_points_back_batch(*_t(pts, *cols))), _np(jax_back(*_j(pts, *cols))),
                               rtol=1e-5, atol=1e-3)


# ----------------------------------------------------------------- metrics


def _metric_case(kind, V=50):
    """(poses, poses_gt, pts, counts, cams, diam, filt) as tests/test_metrics.py builds them."""
    rng = np.random.default_rng(0)
    b, oc = 2, 3
    pts = rng.uniform(-0.05, 0.05, (b, oc, 1, V, 3)).astype(np.float32)
    counts = np.full((b, oc, 1), V, np.int32)
    poses_gt = np.zeros((b, oc, 1, 3, 4), np.float32)
    poses_gt[:, :, 0, :, :3] = Rotation.random(b * oc, random_state=3).as_matrix().reshape(b, oc, 3, 3)
    poses_gt[:, :, 0, :, 3] = [0.05, -0.02, 0.9]
    diam = np.full((b, oc, 1, 1), 0.1, np.float32)
    cams = np.broadcast_to(CAM, (b, 3, 3)).copy()
    filt = np.ones((b, oc), np.int32)
    poses = poses_gt[:, :, 0].copy()
    if kind == "missing_fp":
        poses[0, 0] = 0.0  # missed
        filt[1, 1] = 0  # GT absent, pose given: false positive
    elif kind in ("perturbed", "symmetric"):
        poses[..., :3] = np.einsum("boij,bojk->boik", Rotation.from_rotvec(rng.normal(scale=0.05, size=(b * oc, 3)))
                                   .as_matrix().reshape(b, oc, 3, 3).astype(np.float32), poses[..., :3])
        poses[..., 3] += rng.normal(scale=0.01, size=(b, oc, 3)).astype(np.float32)
    if kind == "symmetric":
        counts[:, 0] = 3417  # the glue rule: ADD-S over 3417 vertices, 4 tiles of the port's 1024
        counts[:, 2] = V - 7
        counts[0, 1] = 7862 if V >= 7862 else counts[0, 1]
    return poses, poses_gt, pts, counts, cams, diam, filt


@pytest.mark.parametrize("kind", ["planted", "missing_fp", "perturbed", "symmetric"])
def test_evaluate_poses(kind):
    from casapose_tpu.pose.metrics import evaluate_poses as jax_evaluate
    from casapose_tpu_torch.pose.metrics import evaluate_poses

    poses, poses_gt, pts, counts, cams, diam, filt = _metric_case(kind, V=3600 if kind == "symmetric" else 50)
    dummy = np.zeros((2, 3, 9, 2), np.float32)
    want = [np.asarray(x) for x in jax_evaluate(*_j(poses, poses_gt, dummy, pts, counts, cams, diam, filt), 5.0)]
    got = [x.numpy() for x in evaluate_poses(*_t(poses, poses_gt, dummy, pts, counts, cams, diam, filt), 5.0)]
    for i in (2, 3, 4, 5, 6):  # valid_2d, valid_3d, missing, valid_count, false_pos: counts
        np.testing.assert_array_equal(got[i], want[i])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-4)  # 2D error sums, px
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-6)  # 3D error sums, m
    if kind == "missing_fp":
        assert got[4][0] == 1 and got[6][1] == 1 and got[0][0] >= 99.9
    if kind == "planted":
        assert (got[3] == 2).all()


# ----------------------------------------------------------------- direction fields


@pytest.mark.parametrize("instances", [1, 2])
def test_get_all_vectorfields(instances):
    from casapose_tpu.ops.vectorfield import get_all_vectorfields as jax_fields
    from casapose_tpu_torch.ops.vectorfield import get_all_vectorfields

    rng = np.random.default_rng(instances)
    labels = rng.integers(0, OC + 1, (B, 16, 20, 1)).astype(np.uint8)
    labels[0, :4, :4] = 0
    target_seg = (labels[..., 0:1] == np.arange(SEG_DIM)).astype(np.float32)
    kp = rng.uniform(0, 20, (B, OC, instances, K, 2)).astype(np.float32)
    kp[0, 0, 0, 0] = [8.5, 10.5]  # a keypoint on a pixel centre: a zero direction stays zero
    for separated in (False, True):
        want = np.asarray(jax_fields(*_j(target_seg, kp, labels), separated))
        got = get_all_vectorfields(*_t(target_seg, kp, labels), separated).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_prepare_device_batch():
    from casapose_tpu.data.pipeline import prepare_device_batch as jax_prepare
    from casapose_tpu_torch.data.pipeline import prepare_device_batch

    rng = np.random.default_rng(2)
    for c, gray in ((3, False), (1, True)):
        img = rng.integers(0, 256, (B, 8, 10, c)).astype(np.uint8)
        seg = rng.integers(0, SEG_DIM, (B, 8, 10, 1)).astype(np.uint8)
        want = jax_prepare(*_j(img, seg), SEG_DIM, grayscale_to_rgb=gray)
        got = prepare_device_batch(*_t(img, seg), SEG_DIM, grayscale_to_rgb=gray)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


# ----------------------------------------------------------------- losses


def _loss_inputs(seed=0, h=12, w=14):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, OC + 1, (B, h, w))
    labels[1, :, :] = np.where(labels[1] == 2, 0, labels[1])  # object 2 absent in image 1
    seg_t = (labels[..., None] == np.arange(SEG_DIM)).astype(np.float32)
    seg_o = rng.normal(size=(B, h, w, SEG_DIM)).astype(np.float32)
    vert_o = rng.normal(size=(B, h, w, 2 * K)).astype(np.float32)
    vert_t = rng.normal(size=(B, h, w, 2 * K)).astype(np.float32)
    kp = rng.uniform(0, h, (B, OC, 1, K, 2)).astype(np.float32)
    return seg_t, seg_o, vert_o, vert_t, kp


@pytest.mark.parametrize("invert", [False, True])
def test_smooth_l1_loss(invert):
    from casapose_tpu.losses.losses import smooth_l1_loss as jax_loss
    from casapose_tpu_torch.losses.losses import smooth_l1_loss

    seg_t, _, vert_o, vert_t, _ = _loss_inputs()
    for reduce in (False, True):
        want = np.asarray(jax_loss(*_j(vert_o * 3, vert_t, seg_t[..., :1]), invert_weights=invert, reduce=reduce))
        got = smooth_l1_loss(*_t(vert_o * 3, vert_t, seg_t[..., :1]), invert_weights=invert, reduce=reduce).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_proxy_voting_dist_and_loss():
    from casapose_tpu.losses import losses as jl
    from casapose_tpu_torch.losses import losses as tl

    seg_t, _, vert_o, _, kp = _loss_inputs(1)
    args = (vert_o, kp, seg_t[..., 1:], seg_t[..., 0:1])
    for wd, td in zip(jl.proxy_voting_dist(*_j(*args), invert_weights=True, min_object_pixel=5),
                      tl.proxy_voting_dist(*_t(*args), invert_weights=True, min_object_pixel=5)):
        np.testing.assert_allclose(td.numpy(), np.asarray(wd), rtol=1e-5, atol=1e-5)
    for kw in (dict(), dict(loss_per_object=True, min_object_pixel=5), dict(reduce=False)):
        want = np.asarray(jl.proxy_voting_loss(*_j(*args), invert_weights=True, **kw))
        got = tl.proxy_voting_loss(*_t(*args), invert_weights=True, **kw).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("flags", ["plain", "filter_vertex", "filter_proxy", "filtered_seg"])
def test_composite_loss(flags):
    from casapose_tpu.losses import losses as jl
    from casapose_tpu_torch.losses import losses as tl

    seg_t, seg_o, vert_o, vert_t, kp = _loss_inputs(2)
    kw = dict(filter_vertex_with_segmentation=flags == "filter_vertex", filter_high_proxy_errors=flags == "filter_proxy")
    extra = {}
    if flags == "filter_proxy":
        extra["pixel_gt_count"] = np.ones((B, OC, 1, 1), np.float32)
    if flags == "filtered_seg":
        extra["filtered_seg"] = np.argmax(seg_o, -1)[..., None].astype(np.int32)
    kp_loss = np.float32(3.25)
    want = jl.composite_loss(*_j(seg_o, seg_t, vert_o, vert_t, kp), jl.LossWeights(**kw),
                             kp_loss=_j(kp_loss), **{k: _j(v) for k, v in extra.items()})
    got = tl.composite_loss(*_t(seg_o, seg_t, vert_o, vert_t, kp), tl.LossWeights(**kw),
                            kp_loss=_t(np.asarray(kp_loss)), **{k: _t(v) for k, v in extra.items()})
    np.testing.assert_allclose([float(x) for x in got], [float(x) for x in want], rtol=1e-5, atol=1e-7)


def _kp_case():
    """Planted poses of 2 objects in 2 images (one unavailable), voted points their exact projections."""
    rng = np.random.default_rng(3)
    h, w = 32, 32
    pts3d = rng.uniform(-0.05, 0.05, (B, OC, 1, K, 3)).astype(np.float32)
    poses_gt = np.zeros((B, OC, 1, 3, 4), np.float32)
    poses_gt[..., :3] = Rotation.random(B * OC, random_state=4).as_matrix().reshape(B, OC, 1, 3, 3)
    poses_gt[..., 3] = [0.01, -0.02, 0.8]
    cam_pts = np.einsum("bocij,bocvj->bocvi", poses_gt[..., :3], pts3d) + poses_gt[..., None, :, 3]
    uv = cam_pts @ CAM.T
    points = (uv[..., :2] / uv[..., 2:])[..., ::-1][:, :, 0] + rng.normal(scale=0.5, size=(B, OC, K, 2))
    offsets = np.array([[0, 0, h, w, 0, 0, 0, 1.0, w, h]] * B, np.float32)
    target_seg = np.zeros((B, h, w, SEG_DIM), np.float32)
    target_seg[..., 0] = 1
    target_seg[:, 2:12, 2:12] = [0, 1, 0]
    target_seg[0, 18:30, 18:30] = [0, 0, 1]  # object 2 absent from image 1's GT
    seg_logits = target_seg * 10.0
    seg_logits[1, 18:30, 18:30] = [0, 0, 10]  # ... but predicted there
    conf = rng.normal(size=(B, h, w, K)).astype(np.float32)
    cams = np.broadcast_to(CAM, (B, 3, 3)).copy()
    return [points.astype(np.float32), seg_logits, poses_gt, pts3d, target_seg, cams, offsets, conf]


@pytest.mark.parametrize("mode", ["plain", "estimate_poses", "bpnp_conf_reg_filter"])
def test_keypoint_reprojection_loss(mode):
    from casapose_tpu.losses.losses import keypoint_reprojection_loss as jax_kp
    from casapose_tpu_torch.losses.losses import keypoint_reprojection_loss

    kw = dict(min_num=20, max_pixel_error=12.5)
    if mode != "plain":
        kw["estimate_poses"] = True
    if mode == "bpnp_conf_reg_filter":
        kw.update(use_bpnp_reprojection_loss=True, confidence_regularization=True, filter_with_gt=True, min_num_gt=1)
    else:
        kw["filter_with_gt"] = False
    args = _kp_case()
    with jax_pnp_accelerator_branch():  # the JAX PnP as on an accelerator: the algorithm of the port's kernel
        want = jax_kp(*_j(*args), **kw)
    got = keypoint_reprojection_loss(*_t(*args), **kw)
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-4)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-5, atol=1e-4)
    if mode == "plain":
        assert got[1] is None and want[1] is None
    else:
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-4, rtol=0)


def test_bpnp_pose_refuses_a_gradient():
    import torch

    from casapose_tpu_torch.pose.bpnp import bpnp_pose

    """Under autograd the pose no longer raises: the placeholder row's gradient is zero, as the JAX VJP zeroes its
    non-finite rows (the VJP is held against JAX in tests/test_torch_train_bpnp.py)."""
    p2, p3 = _t(np.zeros((1, K, 2), np.float32), np.ones((1, K, 3), np.float32))
    p2.requires_grad_()
    out = bpnp_pose(p2, p3, torch.from_numpy(CAM))
    out.sum().backward()
    assert out.shape == (1, 6) and torch.equal(p2.grad, torch.zeros_like(p2))
    assert bpnp_pose(p2.detach(), p3, torch.from_numpy(CAM)).shape == (1, 6)


# ----------------------------------------------------------------- pose evaluation glue


def test_estimate_poses_and_evaluate_pose_estimates():
    from casapose_tpu.pose import evaluation as je
    from casapose_tpu_torch.pose import evaluation as te

    points, _, poses_gt, pts3d, target_seg, cams, offsets, _ = _kp_case()
    points_xy = points[..., ::-1].copy()
    points_xy[1, 1] = 0.0  # no vote: no pose, and no false positive
    filt = np.array([[1, 1], [1, 0]], np.int32)
    with jax_pnp_accelerator_branch():
        want = je.estimate_poses(*_j(points_xy, pts3d, cams, filt, offsets))
    got = te.estimate_poses(*_t(points_xy, pts3d, cams, filt, offsets))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))

    rng = np.random.default_rng(5)
    verts = rng.uniform(-0.05, 0.05, (OC, 3417, 3)).astype(np.float32)
    counts = np.array([[60], [3417]], np.int32)  # object 2 symmetric by the vertex-count rule
    diam = np.full((B, OC, 1, 1), 0.1, np.float32)
    est = np.asarray(want[0])[:, :, None]
    want_stats, _, _ = je.evaluate_pose_estimates(*_j(points_xy, est, poses_gt, target_seg, pts3d, cams, diam),
                                                  evaluation_points=_j(verts), object_points_3d_count=_j(counts), min_num=1)
    got_stats, _, _ = te.evaluate_pose_estimates(*_t(points_xy, est, poses_gt, target_seg, pts3d, cams, diam),
                                                 evaluation_points=_t(verts), object_points_3d_count=_t(counts), min_num=1)
    for i, (g, w) in enumerate(zip(got_stats, want_stats)):
        if i in (4, 5):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _ransac_case(separated, seed=7):
    """Two objects in two images (object 2 absent from image 2's GT, but predicted there) with direction fields to
    the projections of planted poses, noisy; PVNet's layout (one field stack per object) when ``separated``."""
    rng = np.random.default_rng(seed)
    h, w = 40, 48
    cam = np.array([[200.0, 0.0, w / 2], [0.0, 200.0, h / 2], [0.0, 0.0, 1.0]], np.float32)
    pts3d = rng.uniform(-0.05, 0.05, (B, OC, 1, K, 3)).astype(np.float32)
    poses_gt = np.zeros((B, OC, 1, 3, 4), np.float32)
    poses_gt[..., :3] = Rotation.random(B * OC, random_state=8).as_matrix().reshape(B, OC, 1, 3, 3)
    poses_gt[..., 3] = rng.uniform([-0.02, -0.02, 0.75], [0.02, 0.02, 0.85], (B, OC, 1, 3))
    uv = np.einsum("bocij,bocvj->bocvi", poses_gt[..., :3], pts3d) + poses_gt[..., None, :, 3]
    uv = uv @ cam.T
    kp = (uv[..., :2] / uv[..., 2:])[:, :, 0]  # (x, y) [b, oc, K, 2]
    labels = np.zeros((B, h, w), np.int64)
    labels[:, 4:20, 4:22] = 1
    labels[:, 22:38, 24:46] = 2
    target = labels.copy()
    target[1][target[1] == 2] = 0
    target_seg = (target[..., None] == np.arange(SEG_DIM)).astype(np.float32)
    output_seg = (labels[..., None] == np.arange(SEG_DIM)).astype(np.float32) * 5.0 + rng.normal(
        scale=0.1, size=(B, h, w, SEG_DIM)).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w] + 0.5
    fields = np.zeros((B, h, w, OC, K, 2), np.float32)
    for o in range(OC):
        d = np.stack([kp[:, o, None, None, :, 1] - yy[None, :, :, None], kp[:, o, None, None, :, 0] - xx[None, :, :, None]], -1)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        fields[:, :, :, o] = d + rng.normal(scale=0.05, size=d.shape)
    if separated:
        vertex = fields.reshape(B, h, w, OC * K * 2)
    else:
        vertex = np.take_along_axis(fields, np.clip(labels - 1, 0, None)[..., None, None, None], 3)[:, :, :, 0]
        vertex = vertex.reshape(B, h, w, K * 2) * (labels > 0)[..., None]
    offsets = np.array([[0, 0, h, w, 0, 0, 0, 1.0, w, h]] * B, np.float32)
    cams = np.broadcast_to(cam, (B, 3, 3)).copy()
    diam = np.full((B, OC, 1, 1), 0.1, np.float32)
    verts = rng.uniform(-0.05, 0.05, (OC, 3417, 3)).astype(np.float32)
    counts = np.array([[60], [3417]], np.int32)
    return [output_seg, target_seg, vertex.astype(np.float32), poses_gt, pts3d, cams, diam, offsets], verts, counts


@pytest.mark.parametrize("separated", [True, False], ids=["pvnet_fields", "shared_fields"])
def test_estimate_and_evaluate_poses(separated):
    """The RANSAC evaluation, the port voting with the JAX package's own draws: voted points within 1e-3 px (the
    refinement's float32 sums run in another order), poses atol 1e-4 (PnP down the accelerator branch in both),
    metric counts exact, error sums rtol 1e-4 (they move with the voted points, as in the step tests)."""
    from casapose_tpu.pose import evaluation as je
    from casapose_tpu_torch.pose import evaluation as te
    from tests.torch_parity import port_ransac_with_jax_draws

    args, verts, counts = _ransac_case(separated)
    kw = dict(min_num=1, ransac_rounds=2)
    with jax_pnp_accelerator_branch():
        want = je.estimate_and_evaluate_poses(*_j(*args), evaluation_points=_j(verts),
                                              object_points_3d_count=_j(counts), **kw)
    with port_ransac_with_jax_draws() as calls:
        got = te.estimate_and_evaluate_poses(*_t(*args), evaluation_points=_t(verts), object_points_3d_count=_t(counts),
                                             **kw)
    assert calls
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=1e-3, rtol=0)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-4, rtol=0)
    for i, (g, w) in enumerate(zip(got[0], want[0])):
        if i in (4, 5):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0][0].sum() >= 2 and got[0][3].sum() == 1  # 2D-valid poses; the predicted, absent object


# ----------------------------------------------------------------- the model's gt_seg input


def test_model_forward_with_gt_seg():
    import jax
    import torch

    from casapose_tpu.core.checkpoint import unflatten_params
    from casapose_tpu.models.registry import get_model as jax_get_model
    from tests.torch_parity import torch_model

    rng = np.random.default_rng(6)
    img = rng.normal(size=(B, 32, 48, 3)).astype(np.float32)
    labels = rng.integers(0, SEG_DIM, (B, 32, 48))
    gt = (labels[..., None] == np.arange(SEG_DIM)).astype(np.float32)
    jm = jax_get_model("casapose_c_gcu5", ver_dim=3 * K, seg_dim=SEG_DIM)
    flat = calibrated_variables(jm, img)
    want = np.asarray(jax.jit(lambda v, x, g: jm.apply(v, x, g, train=False))(unflatten_params(flat), *_j(img, gt)))
    with torch.no_grad():
        got = torch_model(flat, 3 * K, SEG_DIM)(*_t(img, gt)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # The GT mask, not the prediction, conditions decoder 2: another mask changes the vertex channels only.
    with torch.no_grad():
        other = torch_model(flat, 3 * K, SEG_DIM)(*_t(img, gt[:, :, ::-1].copy())).numpy()
    np.testing.assert_array_equal(other[..., :SEG_DIM], got[..., :SEG_DIM])
    assert np.abs(other[..., SEG_DIM:] - got[..., SEG_DIM:]).max() > 1e-3


# ----------------------------------------------------------------- the step as a whole


def _step_flags(chunk=0, min_size=20):
    return ["--object", "obj_000001,obj_000005", "--modelname", "casapose_c_gcu5", "--estimate_confidence", "1",
            "--estimate_coords", "1", "--no_points", str(K), "--imagesize_test", str(H), str(W),
            "--train_vectors_with_ground_truth", "1", "--min_object_size_test", str(min_size), "--manualseed", "3",
            "--eval_chunk", str(chunk), "--keypoint_loss_weight", "0.007", "--proxy_loss_weight", "0.015",
            "--outf", "unused/out"]


def _scene(n, rng):
    """uint8 images, label maps with an object blob each (object 2 missing from the second image), GT keypoints."""
    img = rng.integers(0, 256, (n, H, W, 3)).astype(np.uint8)
    seg = np.zeros((n, H, W, 1), np.uint8)
    seg[:, 6:30, 8:36] = 1
    seg[:, 34:60, 40:74] = 2
    seg[1::2, 34:60, 40:74] = 0
    kp2d = rng.uniform(0, H, (n, OC, 1, K, 2)).astype(np.float32)
    return img, seg, kp2d


def _well_posed(coords, rng, camera=SHORT_FOCAL):
    """keypoints3d, poses_gt: model points that random poses project exactly onto ``coords`` (y, x) through
    ``camera``, and those poses moved by (6, -4, 8) cm."""
    n = coords.shape[0] * OC
    R = Rotation.random(n, random_state=7).as_matrix()
    t = np.stack([rng.uniform(-0.05, 0.05, n), rng.uniform(-0.05, 0.05, n), rng.uniform(0.75, 0.85, n)], 1)
    xy1 = np.concatenate([coords.reshape(n, K, 2)[..., ::-1], np.ones((n, K, 1))], axis=-1)
    cam_pts = (xy1 @ np.linalg.inv(camera.astype(np.float64)).T) * rng.uniform(0.75, 0.85, (n, K, 1))
    model = np.einsum("bji,bnj->bni", R, cam_pts - t[:, None]).reshape(-1, OC, 1, K, 3)
    poses_gt = np.concatenate([R, (t + [0.06, -0.04, 0.08])[:, :, None]], -1).reshape(-1, OC, 1, 3, 4)
    return model.astype(np.float32), poses_gt.astype(np.float32)


def _batch(model, n, seed=0):
    """A batch in the loader's format whose PnP problems are well-posed for the step's own voted points."""
    import torch

    from casapose_tpu_torch.data.pipeline import prepare_device_batch
    from casapose_tpu_torch.ops.voting import ls_voting

    rng = np.random.default_rng(seed)
    img, seg, kp2d = _scene(n, rng)
    # The step votes on the GT segmentation (train_vectors_with_ground_truth), so the voted points depend
    # only on it and the network's direction channels: vote once here to place the model keypoints.
    with torch.no_grad():
        x, tseg = prepare_device_batch(*_t(img, seg), SEG_DIM)
        out = model(x, tseg)
        coords = ls_voting(tseg, out[..., SEG_DIM : SEG_DIM + 2 * K], out[..., SEG_DIM + 2 * K :], num_points=K,
                           filter_estimates=True, raw_output=out).numpy()
    kp3d, poses_gt = _well_posed(coords, rng)
    return {
        "img": img, "seg": seg, "keypoints2d": kp2d, "keypoints3d": kp3d,
        "camera": np.broadcast_to(SHORT_FOCAL, (n, 3, 3)).copy(),
        "diameters": np.full((n, OC, 1, 1), 1.5, np.float32),
        "offsets": np.array([[0, 0, H, W, 0, 0, 0, 1.0, W, H]] * n, np.float32),
        "poses_gt": poses_gt,
    }


@pytest.fixture(scope="module")
def step_setup():
    from casapose_tpu.models.registry import get_model as jax_get_model
    from tests.torch_parity import torch_model

    rng = np.random.default_rng(11)
    jm = jax_get_model("casapose_c_gcu5", ver_dim=3 * K, seg_dim=SEG_DIM)
    flat = calibrated_variables(jm, rng.normal(size=(B, H, W, 3)).astype(np.float32))
    model = torch_model(flat, 3 * K, SEG_DIM)
    verts = rng.uniform(-0.05, 0.05, (OC, 3417, 3)).astype(np.float32)
    counts = np.array([[50], [3417]], np.int32)  # object 2 symmetric (ADD-S) by the vertex-count rule
    return jm, flat, model, verts, counts


def _port_step(model, verts, counts, chunk=0, min_size=20):
    from casapose_tpu_torch.eval import build_test_step, loss_weights_from_opt
    from casapose_tpu_torch.utils.config import parse_config

    opt = parse_config(_step_flags(chunk, min_size))
    return build_test_step(model, opt, OC, verts, counts, loss_weights_from_opt(opt))


def _run_port(step, batch, plain=()):
    """The step on ``batch``; ``plain`` names kernels whose call sites take their plain versions."""
    from casapose_tpu_torch.ops.plain import plain_kernels

    with plain_kernels(*plain) if plain else contextlib.nullcontext():
        out = step({k: _t(v) for k, v in batch.items()})
    return {k: ([x.numpy() for x in v] if k == "pose_stats" else v.numpy()) for k, v in out.items()}


@pytest.fixture(scope="module", params=[20, 2000])
def step_case(step_setup, request):
    """The JAX step on one batch, with its PnP down the accelerator branch (the Pallas kernel, interpret mode).

    Parametrised by --min_object_size_test: at 20 px every predicted object is available and the object that
    the second image's GT lacks is a false positive; at 2000 px the smaller predicted object is not, and where
    its GT is present it counts as missing.
    """
    import jax
    import jax.numpy as jnp

    from casapose_tpu.core.checkpoint import unflatten_params
    from casapose_tpu.eval import build_test_step as jax_build
    from casapose_tpu.losses.losses import LossWeights as JaxWeights
    from casapose_tpu.utils.config import parse_config as jax_parse

    jm, flat, model, verts, counts = step_setup
    batch = _batch(model, B)
    opt = jax_parse(_step_flags(min_size=request.param))
    lw = JaxWeights(mask_loss_weight=opt.mask_loss_weight, vertex_loss_weight=opt.vertex_loss_weight,
                    proxy_loss_weight=opt.proxy_loss_weight, kp_loss_weight=opt.keypoint_loss_weight)
    step = jax_build(jm, opt, OC, verts, counts, lw)
    with jax_pnp_accelerator_branch() as calls:  # traced here, so the JAX step's PnP is the Pallas kernel
        out = step(unflatten_params(flat), {k: jnp.asarray(v) for k, v in batch.items()})
        out = jax.tree_util.tree_map(np.asarray, out)
    assert calls, "the JAX solve_pnp did not take its Pallas branch"
    return request.param, batch, out


def test_step_matches_jax(step_setup, step_case):
    _, _, model, verts, counts = step_setup
    min_size, batch, want = step_case
    got = _run_port(_port_step(model, verts, counts, min_size=min_size), batch)
    assert set(got) == set(want) - {"proxy_dist"}
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
    for i in (0, 1, 2, 3, 6, 7):  # valid_2d, valid_3d, valid_count, zeros, missing, false_positive
        np.testing.assert_array_equal(got["pose_stats"][i], want["pose_stats"][i])
    for i in (4, 5):  # 2D / 3D error sums
        np.testing.assert_allclose(got["pose_stats"][i], want["pose_stats"][i], rtol=1e-4)
    assert got["pose_stats"][2].sum() == 3  # GT objects
    assert got["pose_stats"][0].sum() > 0 and got["pose_stats"][1].sum() > 0  # some 2D- and 3D-valid poses
    assert got["pose_stats"][7 if min_size == 20 else 6].sum() > 0  # a false positive, or a missing object
    np.testing.assert_allclose(got["estimated_poses"], want["estimated_poses"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got["estimated_points"], want["estimated_points"], rtol=1e-4, atol=5e-3)
    np.testing.assert_allclose(got["proxy_per_object"], want["proxy_per_object"], rtol=1e-4, atol=1e-5)
    for key in ("output_seg", "output_dirs", "confidence"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["target_dirs"], want["target_dirs"], rtol=1e-5, atol=1e-6)


def test_step_kernel_branch_plain_matches_default(step_setup, step_case):
    """Under ``plain_kernels()`` the step takes the kernels' branch (voting from the raw output) with their plain
    versions."""
    _, _, model, verts, counts = step_setup
    min_size, batch, _ = step_case
    got = _run_port(_port_step(model, verts, counts, min_size=min_size), batch, plain=("voting", "pnp"))
    ref = _run_port(_port_step(model, verts, counts, min_size=min_size), batch)
    np.testing.assert_allclose(got["estimated_points"], ref["estimated_points"], rtol=1e-4, atol=5e-3)
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-4)
    for i in (0, 1, 2, 6, 7):
        np.testing.assert_array_equal(got["pose_stats"][i], ref["pose_stats"][i])


@pytest.mark.parametrize("n, chunk", [(5, 2), (4, 2)])
def test_chunked_step_equals_unchunked(step_setup, n, chunk):
    """--eval_chunk: counters exact, per-image outputs equal, losses the image-weighted mean (rtol 2e-5, as the
    JAX package's tests/test_batched_eval.py), error sums rtol 1e-4 (see the module's note); 5 = 2 + 2 + a
    1-image tail."""
    _, _, model, verts, counts = step_setup
    batch = _batch(model, n, seed=n)
    whole = _run_port(_port_step(model, verts, counts), batch)
    chunked = _run_port(_port_step(model, verts, counts, chunk=chunk), batch)
    np.testing.assert_allclose(chunked["losses"], whole["losses"], rtol=2e-5, atol=2e-5)
    for i in (0, 1, 2, 6, 7):
        np.testing.assert_array_equal(chunked["pose_stats"][i], whole["pose_stats"][i])
    for i in (4, 5):
        np.testing.assert_allclose(chunked["pose_stats"][i], whole["pose_stats"][i], rtol=1e-4)
    np.testing.assert_allclose(chunked["estimated_poses"], whole["estimated_poses"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(chunked["estimated_points"], whole["estimated_points"], rtol=1e-4, atol=5e-3)
    np.testing.assert_allclose(chunked["output_seg"], whole["output_seg"], rtol=1e-5, atol=1e-5)
    assert chunked["output_seg"].shape[0] == n


def test_unported_options_raise(step_setup):
    """The visual dumps and the trace, refused before, build the step; with
    ``--save_eval_batches`` it returns the JAX step's ``proxy_dist`` extra. Tolerance rtol 1e-4, atol 1e-2 px: each
    distance is a difference of products of pixel coordinates (up to ~80) with direction channels that agree to
    1e-4, which cancels near the keypoint (measured: 16 of 92,160 distances of ~1 px apart by up to 3.6e-3)."""
    import jax.numpy as jnp

    from casapose_tpu.core.checkpoint import unflatten_params
    from casapose_tpu.eval import build_test_step as jax_build
    from casapose_tpu.losses.losses import LossWeights as JaxWeights
    from casapose_tpu.utils.config import parse_config as jax_parse
    from casapose_tpu_torch.eval import build_test_step
    from casapose_tpu_torch.losses.losses import LossWeights
    from casapose_tpu_torch.utils.config import parse_config

    jm, flat, model, verts, counts = step_setup
    build_test_step(model, parse_config(_step_flags() + ["--profile_dir", "prof"]), OC, verts, counts, LossWeights())
    flags = _step_flags() + ["--save_eval_batches", "1"]
    batch = _batch(model, B)
    got = _run_port(build_test_step(model, parse_config(flags), OC, verts, counts, LossWeights()), batch)
    want = jax_build(jm, jax_parse(flags), OC, verts, counts, JaxWeights())(
        unflatten_params(flat), {k: jnp.asarray(v) for k, v in batch.items()})
    assert got["proxy_dist"].shape == (B, H, W, K)
    np.testing.assert_allclose(got["proxy_dist"], np.asarray(want["proxy_dist"]), rtol=1e-4, atol=1e-2)


def test_least_squares_without_confidence_is_refused_as_by_jax(step_setup):
    """``estimate_coords 1`` with ``estimate_confidence 0``: the JAX step hands ``confidence=None`` to ``ls_voting``
    and fails in its softplus; the port refuses the combination when the step is built, and names the RANSAC
    branch."""
    import jax.numpy as jnp

    from casapose_tpu.core.checkpoint import unflatten_params
    from casapose_tpu.eval import build_test_step as jax_build
    from casapose_tpu.losses.losses import LossWeights as JaxWeights
    from casapose_tpu.utils.config import parse_config as jax_parse
    from casapose_tpu_torch.eval import build_test_step
    from casapose_tpu_torch.losses.losses import LossWeights
    from casapose_tpu_torch.utils.config import parse_config

    jm, flat, model, verts, counts = step_setup
    flags = _step_flags() + ["--estimate_confidence", "0"]
    with pytest.raises(ValueError, match="estimate_coords 0"):
        build_test_step(model, parse_config(flags), OC, verts, counts, LossWeights())
    step = jax_build(jm, jax_parse(flags), OC, verts, counts, JaxWeights())
    batch = {k: jnp.asarray(v) for k, v in _batch(model, B).items()}
    with pytest.raises(TypeError, match="logaddexp"):
        step(unflatten_params(flat), batch)


def test_int8_step_matches_jax(step_setup, monkeypatch):
    """``--quantized_inference int8``: the port's step against the JAX package's int8 step on the same batch.

    The int8 network itself is held against the JAX package's layer by layer in tests/test_torch_quant.py; end to
    end the two int8 forwards part at rounding ties (see there), so the port's forward is held here within the
    distance at which int8 lies from float32 (median 2e-2 of each head's max, tests/test_quant.py's band; measured
    ~7e-3), and the rest of the step runs on the JAX step's own int8 network output: the port's ``quantized_apply``
    is called as the JAX step calls its own (the image, the GT mask for decoder 2, eval mode) and its result is
    swapped for JAX's. Losses, counts, poses and points are then held as test_step_matches_jax holds them."""
    import jax
    import jax.numpy as jnp
    import torch

    import casapose_tpu_torch.eval as port_eval
    from casapose_tpu.core.checkpoint import unflatten_params
    from casapose_tpu.eval import build_test_step as jax_build
    from casapose_tpu.losses.losses import LossWeights as JaxWeights
    from casapose_tpu.utils.config import parse_config as jax_parse
    from casapose_tpu_torch.utils.config import parse_config

    jm, flat, model, verts, counts = step_setup
    flags = _step_flags() + ["--quantized_inference", "int8"]
    batch = _batch(model, B)
    opt = jax_parse(flags)
    lw = JaxWeights(mask_loss_weight=opt.mask_loss_weight, vertex_loss_weight=opt.vertex_loss_weight,
                    proxy_loss_weight=opt.proxy_loss_weight, kp_loss_weight=opt.keypoint_loss_weight)
    with jax_pnp_accelerator_branch() as pnp_calls:
        want = jax.tree_util.tree_map(np.asarray, jax_build(jm, opt, OC, verts, counts, lw)(
            unflatten_params(flat), {k: jnp.asarray(v) for k, v in batch.items()}))
    assert pnp_calls, "the JAX solve_pnp did not take its Pallas branch"
    jax_net = np.concatenate([want["output_seg"], want["output_dirs"], want["confidence"]], axis=-1)

    real = port_eval.quantized_apply
    seen = []

    def jax_network_output(m, img, gt_seg):
        out = real(m, img, gt_seg)
        seen.append((m, gt_seg is not None, out))
        return torch.from_numpy(jax_net)

    monkeypatch.setattr(port_eval, "quantized_apply", jax_network_output)
    opt_port = parse_config(flags)
    got = _run_port(port_eval.build_test_step(model, opt_port, OC, verts, counts,
                                              port_eval.loss_weights_from_opt(opt_port)), batch)
    (m, with_gt, out), = seen
    assert m is model and with_gt
    out = out.numpy()
    for sl in (slice(0, SEG_DIM), slice(SEG_DIM, None)):
        assert np.median(np.abs(out[..., sl] - jax_net[..., sl])) < 2e-2 * np.abs(jax_net[..., sl]).max()
    assert not model.training

    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
    for i in (0, 1, 2, 3, 6, 7):
        np.testing.assert_array_equal(got["pose_stats"][i], want["pose_stats"][i])
    for i in (4, 5):
        np.testing.assert_allclose(got["pose_stats"][i], want["pose_stats"][i], rtol=1e-4)
    np.testing.assert_allclose(got["estimated_poses"], want["estimated_poses"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got["estimated_points"], want["estimated_points"], rtol=1e-4, atol=5e-3)
