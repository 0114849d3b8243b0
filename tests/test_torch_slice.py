"""The port's whole inference step against the JAX package's, on the CPU, with shared weights.

64x64 images, batch 2, 3 objects, 9 keypoints: ``casapose_c_gcu5`` ->
CC-filtered ``ls_voting(raw_output=...)`` -> ``poses_pnp``, as in
``bench.py::build_inference_case``. The JAX step runs once per module.

Tolerances: network output rtol 1e-4, atol 1e-4; voted points rtol 1e-4,
atol 5e-3 px. Poses are compared elementwise (atol 1e-4) where the JAX pose
reprojects below 1 px RMS; elsewhere the port's reprojection error must be
no worse than JAX's times (1 + 1e-3) plus 1e-4.

Random weights vote all keypoints of an object within a few pixels of each
other, so against random model points every PnP problem is ill-posed and
two solvers may stop in different minima. Two cases therefore:
  * well-posed: model keypoints that a random pose projects exactly onto
    the voted points, seen by a short-focal camera (f = 16 px) so that the
    few pixels of spread are a wide angle; held against the JAX
    ``poses_pnp`` as it runs on the CPU;
  * ill-posed: random model keypoints and the flagship camera; held against
    the JAX ``poses_pnp`` down its accelerator branch (the Pallas PnP
    kernel, interpret mode), whose algorithm the port's PnP kernel follows.
"""

import numpy as np
import pytest

from tests.torch_parity import CAMERA, calibrated_variables, jax_poses_pnp_accelerator_path, torch_model

OC, K, H, W, B = 3, 9, 64, 64, 2
SEG_DIM = 1 + OC
SHORT_FOCAL = np.array([[16.0, 0.0, 32.0], [0.0, 16.0, 32.0], [0.0, 0.0, 1.0]], np.float32)


def _reprojection_sq(poses, coords, kp3, camera):
    """Sum over keypoints of squared pixel residuals of [b, oc, 1, 3, 4] poses on (y, x) points (numpy)."""
    Rt = poses.reshape(-1, 3, 4).astype(np.float64)
    X = kp3.reshape(-1, K, 3).astype(np.float64)
    cam = X @ np.swapaxes(Rt[:, :, :3], 1, 2) + Rt[:, None, :, 3]
    z = np.where(np.abs(cam[..., 2]) < 1e-9, 1e-9, cam[..., 2])
    u = camera[0, 0] * cam[..., 0] / z + camera[0, 2]
    v = camera[1, 1] * cam[..., 1] / z + camera[1, 2]
    pts = coords.reshape(-1, K, 2)
    return ((u - pts[..., 1]) ** 2 + (v - pts[..., 0]) ** 2).sum(axis=1)


def _consistent_keypoints(coords, rng, camera):
    """Model keypoints [b, oc, 1, k, 3] that a random pose projects exactly onto the voted (y, x) points."""
    from scipy.spatial.transform import Rotation

    n = B * OC
    R = Rotation.random(n, random_state=1).as_matrix()
    t = np.stack([rng.uniform(-0.05, 0.05, n), rng.uniform(-0.05, 0.05, n), rng.uniform(0.75, 0.85, n)], 1)
    xy1 = np.concatenate([coords.reshape(n, K, 2)[..., ::-1], np.ones((n, K, 1))], axis=-1)
    cam_pts = (xy1 @ np.linalg.inv(camera.astype(np.float64)).T) * rng.uniform(0.75, 0.85, (n, K, 1))
    model_pts = np.einsum("bji,bnj->bni", R, cam_pts - t[:, None])  # R^T (X_cam - t)
    return model_pts.reshape(B, OC, 1, K, 3).astype(np.float32)


@pytest.fixture(scope="module")
def case():
    import jax
    import jax.numpy as jnp

    from casapose_tpu.core.checkpoint import unflatten_params
    from casapose_tpu.models.registry import get_model as jax_get_model
    from casapose_tpu.ops.voting import ls_voting as jax_ls_voting
    from casapose_tpu.pose.evaluation import poses_pnp as jax_poses_pnp

    rng = np.random.default_rng(0)
    img = rng.normal(size=(B, H, W, 3)).astype(np.float32)
    jm = jax_get_model("casapose_c_gcu5", ver_dim=3 * K, seg_dim=SEG_DIM)
    flat = calibrated_variables(jm, img)

    @jax.jit
    def step(variables, img, kp3, cam):
        out = jm.apply(variables, img, train=False)
        seg = out[..., :SEG_DIM]
        dirs = out[..., SEG_DIM : SEG_DIM + 2 * K]
        conf = out[..., SEG_DIM + 2 * K :]
        coords = jax_ls_voting(seg, dirs, conf, num_points=K, filter_estimates=True, raw_output=out)
        return out, coords, jax_poses_pnp(coords, seg, kp3, cam, OC)

    variables = unflatten_params(flat)
    ill = {"kp3": rng.uniform(-0.05, 0.05, (B, OC, 1, K, 3)).astype(np.float32), "cam": np.broadcast_to(CAMERA, (B, 3, 3)).copy()}
    out, coords, _ = (np.asarray(x) for x in step(variables, jnp.asarray(img), jnp.asarray(ill["kp3"]), jnp.asarray(ill["cam"])))
    ill["poses"] = jax_poses_pnp_accelerator_path(coords, out[..., :SEG_DIM], ill["kp3"], ill["cam"], OC)
    well = {"kp3": _consistent_keypoints(coords, rng, SHORT_FOCAL), "cam": np.broadcast_to(SHORT_FOCAL, (B, 3, 3)).copy()}
    well["poses"] = np.asarray(step(variables, jnp.asarray(img), jnp.asarray(well["kp3"]), jnp.asarray(well["cam"]))[2])
    return img, flat, out, coords, {"well": well, "ill": ill}


@pytest.fixture(scope="module")
def port(case):
    import torch

    from casapose_tpu_torch.ops.voting import ls_voting
    from casapose_tpu_torch.pose.evaluation import poses_pnp

    img, flat, _, _, pose_cases = case
    model = torch_model(flat, 3 * K, SEG_DIM)
    with torch.no_grad():
        out = model(torch.from_numpy(img))
        seg = out[..., :SEG_DIM]
        dirs = out[..., SEG_DIM : SEG_DIM + 2 * K]
        conf = out[..., SEG_DIM + 2 * K :]
        coords = ls_voting(seg, dirs, conf, num_points=K, filter_estimates=True, raw_output=out)
        poses = {
            name: poses_pnp(coords, seg, torch.from_numpy(c["kp3"]), torch.from_numpy(c["cam"]), OC).numpy()
            for name, c in pose_cases.items()
        }
    return out.numpy(), coords.numpy(), poses


def test_network_output_matches(case, port):
    np.testing.assert_allclose(port[0], case[2], rtol=1e-4, atol=1e-4)


def test_voted_points_match(case, port):
    np.testing.assert_allclose(port[1], case[3], rtol=1e-4, atol=5e-3)


@pytest.mark.parametrize("which", ["well", "ill"])
def test_poses_match_or_reproject_no_worse(case, port, which):
    c = case[4][which]
    poses, poses_ref = port[2][which], c["poses"]
    assert poses.shape == (B, OC, 1, 3, 4) and np.isfinite(poses).all()
    e_port = _reprojection_sq(poses, port[1], c["kp3"], c["cam"][0])
    e_ref = _reprojection_sq(poses_ref, case[3], c["kp3"], c["cam"][0])
    good = e_ref < K * 1.0
    if which == "well":
        assert good.all(), f"the well-posed case has detections above 1 px RMS: {e_ref}"
    d_pose = np.abs(poses - poses_ref).reshape(-1, 12).max(axis=1)
    assert (d_pose[good] <= 1e-4).all(), d_pose
    assert (e_port[~good] <= e_ref[~good] * (1 + 1e-3) + 1e-4).all(), (e_port, e_ref)


def test_step_entry_point_runs_on_the_cpu_when_asked():
    import torch

    from casapose_tpu_torch.entry import build_inference_step

    step, model = build_inference_step(no_objects=OC, k=K, h=H, w=W, device="cpu")
    rng = np.random.default_rng(1)
    img = torch.from_numpy(rng.normal(size=(B, H, W, 3)).astype(np.float32))
    kp3 = torch.from_numpy(rng.uniform(-0.05, 0.05, (B, OC, 1, K, 3)).astype(np.float32))
    poses, coords = step(img, kp3, torch.from_numpy(np.broadcast_to(CAMERA, (B, 3, 3)).copy()), return_points=True)
    assert poses.shape == (B, OC, 1, 3, 4) and coords.shape == (B, OC, K, 2)
    assert torch.isfinite(poses).all()
    assert not model.training
    with pytest.raises(ValueError):
        step(img[:, :32], kp3, torch.from_numpy(np.broadcast_to(CAMERA, (B, 3, 3)).copy()))
