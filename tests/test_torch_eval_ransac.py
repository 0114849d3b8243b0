"""The port's evaluation step down its RANSAC branch (``estimate_coords 0``) against the JAX package's, on the CPU.

Two configurations: ``pvnet`` (one direction-field stack per object, no
confidence channels, the reference's RANSAC configuration) and the flagship
``casapose_c_gcu5`` with ``estimate_confidence 0``. 64x80, 2 objects, 9
keypoints, batch 2, ``--ransac_rounds 2``, weights carried across from JAX.
The port votes with the JAX package's own draws (tests/torch_parity.py::
port_ransac_with_jax_draws) and both solve PnP down the accelerator branch.
As in tests/test_torch_eval.py, the model keypoints are placed where random
poses project them exactly onto the points the step votes, so that its PnP
problems are well-posed. Random weights vote points up to ~200 px outside
the image, so the camera has f = 200 px (with tests/test_torch_eval.py's
f = 16 px these points lie 12 focal lengths off axis, and a PnP solve moves
by 0.3 when a point moves by 2e-3 px).

RANSAC's inlier test is a threshold on a cosine. The two networks' outputs
agree to 1e-4, which flips the test for the candidates within ~1e-5 of the
threshold (there are thousands in a pair's 512 x 2 hypotheses), and a
different hypothesis can win: measured, one keypoint of 36 voted 19.7 px
apart. So the step is held in two parts. With its own network, the port's
step gives the JAX step's network outputs, direction fields and losses
(which do not depend on the voting). With the JAX network's output in
place of its network, the port's step gives the JAX step's voted points,
poses and metrics.

Tolerances, as tests/test_torch_eval.py holds the LS step: losses rtol
1e-4, metric counts exact, error sums rtol 1e-4 (with an atol of the voted
points' 5e-3 px, and 1e-5 m in 3D), poses atol 1e-4, voted
points rtol 1e-4 / atol 5e-3 px (the refinement sums ~5000 inliers per
keypoint in float32 in another order than XLA's dot; tests/test_torch_ransac.py
holds RANSAC alone at 1e-3 px); network outputs rtol/atol 1e-4; direction
fields rtol 1e-5.
"""

import numpy as np
import pytest

from tests.test_torch_eval import OC, H, W, B, K, _scene, _t, _well_posed
from tests.torch_parity import calibrated_variables, jax_pnp_accelerator_branch, port_ransac_with_jax_draws

SEG_DIM = 1 + OC
CAMERA = np.array([[200.0, 0.0, W / 2], [0.0, 200.0, H / 2], [0.0, 0.0, 1.0]], np.float32)
CASES = {"pvnet": ("pvnet", 2 * K * OC), "casapose_c_gcu5_no_confidence": ("casapose_c_gcu5", 2 * K)}


def _flags(name):
    return ["--object", "obj_000001,obj_000005", "--modelname", name, "--estimate_confidence", "0",
            "--estimate_coords", "0", "--no_points", str(K), "--imagesize_test", str(H), str(W),
            "--train_vectors_with_ground_truth", "1", "--min_object_size_test", "20", "--manualseed", "3",
            "--ransac_rounds", "2", "--keypoint_loss_weight", "0.007", "--proxy_loss_weight", "0.015",
            "--outf", "unused/out"]


def _port_step(model, name, verts, counts):
    from casapose_tpu_torch.eval import build_test_step, loss_weights_from_opt
    from casapose_tpu_torch.utils.config import parse_config

    opt = parse_config(_flags(name))
    return build_test_step(model, opt, OC, verts, counts, loss_weights_from_opt(opt))


def _run(step, batch):
    with port_ransac_with_jax_draws() as calls:
        out = step({k: _t(v) for k, v in batch.items()})
    assert calls, "the step did not vote by RANSAC"
    return {k: ([x.numpy() for x in v] if k == "pose_stats" else v.numpy()) for k, v in out.items()}


class _FixedOutput:
    """Stands in for the network: returns the JAX network's output for the batch (the step reads its device from
    ``parameters()``)."""

    def __init__(self, output):
        import torch

        self.output = torch.from_numpy(np.ascontiguousarray(output))
        self.weight = torch.zeros(1)

    def parameters(self):
        return iter([self.weight])

    def __call__(self, img, gt_seg=None):
        return self.output


@pytest.fixture(scope="module", params=list(CASES))
def ransac_case(request):
    import jax
    import jax.numpy as jnp

    from casapose_tpu.core.checkpoint import unflatten_params
    from casapose_tpu.eval import build_test_step as jax_build
    from casapose_tpu.losses.losses import LossWeights as JaxWeights
    from casapose_tpu.models.registry import get_model as jax_get_model
    from casapose_tpu.utils.config import parse_config as jax_parse

    from casapose_tpu_torch.core.convert import from_jax_variables
    from casapose_tpu_torch.models.registry import get_model

    name, ver_dim = CASES[request.param]
    rng = np.random.default_rng(21)
    jm = jax_get_model(name, ver_dim=ver_dim, seg_dim=SEG_DIM)
    flat = calibrated_variables(jm, rng.normal(size=(B, H, W, 3)).astype(np.float32))
    model = get_model(name, ver_dim, SEG_DIM, device="cpu")
    model.load_state_dict(from_jax_variables(flat, model))
    verts = rng.uniform(-0.05, 0.05, (OC, 3417, 3)).astype(np.float32)
    counts = np.array([[50], [3417]], np.int32)
    opt = jax_parse(_flags(name))
    lw = JaxWeights(mask_loss_weight=opt.mask_loss_weight, vertex_loss_weight=opt.vertex_loss_weight,
                    proxy_loss_weight=opt.proxy_loss_weight, kp_loss_weight=opt.keypoint_loss_weight)
    jax_step = jax_build(jm, opt, OC, verts, counts, lw)

    traced = []

    def run_jax(batch):  # traced at the first call (with the PnP kernel), then the same program
        with jax_pnp_accelerator_branch() as calls:
            out = jax_step(unflatten_params(flat), {k: jnp.asarray(v) for k, v in batch.items()})
            out = jax.tree_util.tree_map(np.asarray, out)
        traced.extend(calls)
        assert traced, "the JAX solve_pnp did not take its Pallas branch"
        return out

    img, seg, kp2d = _scene(B, rng)
    batch = {"img": img, "seg": seg, "keypoints2d": kp2d,
             "keypoints3d": rng.uniform(-0.05, 0.05, (B, OC, 1, K, 3)).astype(np.float32),
             "camera": np.broadcast_to(CAMERA, (B, 3, 3)).copy(),
             "diameters": np.full((B, OC, 1, 1), 1.5, np.float32),
             "offsets": np.array([[0, 0, H, W, 0, 0, 0, 1.0, W, H]] * B, np.float32),
             "poses_gt": np.zeros((B, OC, 1, 3, 4), np.float32)}
    first = run_jax(batch)
    jax_net = _FixedOutput(np.concatenate([first["output_seg"], first["output_dirs"]], axis=-1))
    # Vote once to place the model keypoints (the voted points depend only on the image and the network).
    points = _run(_port_step(jax_net, name, verts, counts), batch)["estimated_points"]  # (x, y)
    batch["keypoints3d"], batch["poses_gt"] = _well_posed(np.ascontiguousarray(points[..., ::-1]), rng, CAMERA)
    want = run_jax(batch)
    own = _run(_port_step(model, name, verts, counts), batch)
    on_jax_output = _run(_port_step(jax_net, name, verts, counts), batch)
    return request.param, own, on_jax_output, want


def test_ransac_step_network_fields_and_losses_match_jax(ransac_case):
    name, got, _, want = ransac_case
    assert set(got) == set(want) - {"proxy_dist"}
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
    assert got["losses"][4] == 0.0  # no keypoint loss on this branch
    np.testing.assert_allclose(got["proxy_per_object"], want["proxy_per_object"], rtol=1e-4, atol=1e-5)
    for key in ("output_seg", "output_dirs"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got["confidence"], want["confidence"])  # zeros: no confidence channels
    np.testing.assert_allclose(got["target_dirs"], want["target_dirs"], rtol=1e-5, atol=1e-6)
    assert got["target_dirs"].shape[-1] == (2 * K * OC if name == "pvnet" else 2 * K)  # PVNet: per-object stacks
    for i in (2, 6):  # GT objects and missing ones do not depend on the voting
        np.testing.assert_array_equal(got["pose_stats"][i], want["pose_stats"][i])


def test_ransac_step_matches_jax_on_the_jax_network_output(ransac_case):
    _, _, got, want = ransac_case
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
    for i in (0, 1, 2, 3, 6, 7):  # valid_2d, valid_3d, valid_count, false-positive mask, missing, false_positive
        np.testing.assert_array_equal(got["pose_stats"][i], want["pose_stats"][i])
    # The error sums move with the voted points (atol 5e-3 px): 2D sums also atol 5e-3 px, 3D sums 1e-5 m.
    np.testing.assert_allclose(got["pose_stats"][4], want["pose_stats"][4], rtol=1e-4, atol=5e-3)
    np.testing.assert_allclose(got["pose_stats"][5], want["pose_stats"][5], rtol=1e-4, atol=1e-5)
    assert got["pose_stats"][2].sum() == 3  # GT objects
    np.testing.assert_allclose(got["estimated_points"], want["estimated_points"], rtol=1e-4, atol=5e-3)
    np.testing.assert_allclose(got["estimated_poses"], want["estimated_poses"], atol=1e-4, rtol=0)
