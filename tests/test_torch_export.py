"""The serving export (``casapose_tpu_torch/core/export.py``) on the CPU: round trip and parity with JAX.

``casapose_c_gcu5`` at 64x64, 2 objects, 9 keypoints, batch 2, calibrated
weights shared with the JAX package; model keypoints planted so that the PnP
problems are well-posed for the voted points (a short-focal camera, as
tests/test_torch_slice.py's well-posed case), because the JAX serving
function solves PnP with its CPU (XLA) algorithm and the port's program with
the PnP kernel's: on well-posed problems both find the planted minimum.

Tolerances:
  * the loaded program against the live serving function: rtol / atol 1e-6,
    tests/test_export.py's band for the JAX artifact (equal bit for bit here:
    the program runs the same operators);
  * against the JAX package's ``build_serving_fn`` on the same weights and
    inputs: poses atol 1e-4, the step parity band of tests/test_torch_slice.py.
"""

import numpy as np
import pytest

from tests.torch_parity import calibrated_variables, single_torch_thread, torch_model  # noqa: F401 (autouse)

OC, K, H, W, B = 2, 9, 64, 64, 2
SEG_DIM = 1 + OC
SHORT_FOCAL = np.array([[16.0, 0.0, 32.0], [0.0, 16.0, 32.0], [0.0, 0.0, 1.0]], np.float32)


@pytest.fixture(scope="module")
def case():
    import torch
    from scipy.spatial.transform import Rotation

    from casapose_tpu.models.registry import get_model as jax_get_model
    from casapose_tpu_torch.ops.voting import ls_voting

    rng = np.random.default_rng(0)
    img = rng.normal(size=(B, H, W, 3)).astype(np.float32)
    jm = jax_get_model("casapose_c_gcu5", ver_dim=3 * K, seg_dim=SEG_DIM)
    flat = calibrated_variables(jm, img)
    model = torch_model(flat, 3 * K, SEG_DIM)
    with torch.no_grad():
        out = model(torch.from_numpy(img))
        coords = ls_voting(out[..., :SEG_DIM], out[..., SEG_DIM : SEG_DIM + 2 * K], out[..., SEG_DIM + 2 * K :],
                           num_points=K, filter_estimates=True, raw_output=out).numpy()
    n = B * OC
    R = Rotation.random(n, random_state=1).as_matrix()
    t = np.stack([rng.uniform(-0.05, 0.05, n), rng.uniform(-0.05, 0.05, n), rng.uniform(0.75, 0.85, n)], 1)
    xy1 = np.concatenate([coords.reshape(n, K, 2)[..., ::-1], np.ones((n, K, 1))], axis=-1)
    cam_pts = (xy1 @ np.linalg.inv(SHORT_FOCAL.astype(np.float64)).T) * rng.uniform(0.75, 0.85, (n, K, 1))
    kp3 = np.einsum("bji,bnj->bni", R, cam_pts - t[:, None]).reshape(B, OC, 1, K, 3).astype(np.float32)
    cam = np.broadcast_to(SHORT_FOCAL, (B, 3, 3)).copy()
    return jm, flat, model, img, kp3, cam


@pytest.fixture(scope="module")
def exported(case):
    from casapose_tpu_torch.core.export import export_inference

    _, _, model, _, _, _ = case
    return export_inference(model, B, H, W, OC, K, device="cpu")


def test_exported_program_round_trip_equals_the_live_function(case, exported):
    import io

    import torch

    from casapose_tpu_torch.core.export import build_serving_fn, load_exported

    _, _, model, img, kp3, cam = case
    args = tuple(torch.from_numpy(a) for a in (img, kp3, cam))
    with torch.no_grad():
        live = build_serving_fn(model, OC, K)(*args)
    got = load_exported(exported)(*args)
    assert got.shape == (B, OC, 1, 3, 4) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), live.numpy(), rtol=1e-6, atol=1e-6)
    # The CC labelling and the PnP solve are one operator each; on the CPU the voting sums are the einsum form, as in
    # the live function (on the card the program calls casapose::voting_accumulate, chip_smoke.py phase 25).
    targets = {str(n.target) for n in torch.export.load(io.BytesIO(exported)).graph.nodes if n.op == "call_function"}
    casapose = sorted(t for t in targets if t.startswith("casapose."))
    assert casapose == ["casapose.connected_components.default", "casapose.solve_pnp.default"], casapose


def test_exported_program_matches_jax_serving_fn(case, exported):
    import jax
    import jax.numpy as jnp
    import torch

    from casapose_tpu.core.checkpoint import unflatten_params
    from casapose_tpu.core.export import build_serving_fn as jax_build_serving_fn
    from casapose_tpu_torch.core.export import load_exported

    jm, flat, _, img, kp3, cam = case
    fn = jax.jit(jax_build_serving_fn(jm, unflatten_params(flat), OC, K))
    want = np.asarray(fn(jnp.asarray(img), jnp.asarray(kp3), jnp.asarray(cam)))
    got = load_exported(exported)(*(torch.from_numpy(a) for a in (img, kp3, cam))).numpy()
    assert (np.abs(want).reshape(-1, 12).sum(1) > 0).all()  # every object available and solved
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_export_refuses_a_model_elsewhere_or_in_training_mode(case):
    from casapose_tpu_torch.core.export import export_inference

    _, _, model, _, _, _ = case
    with pytest.raises(ValueError, match="must lie on meta"):
        export_inference(model, B, H, W, OC, K, device="meta")
    model.train()
    try:
        with pytest.raises(ValueError, match="eval mode"):
            export_inference(model, B, H, W, OC, K, device="cpu")
    finally:
        model.eval()
