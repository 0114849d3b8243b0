"""Loss gradients of the port's train step against ``jax.grad``, on the CPU.

The step's configuration is ``__graft_entry__.py::build_synthetic_train_case``'s
(casapose_c_gcu5, 2 objects, 3 keypoints, 32x32, batch 2, random dense
labels, GT masks for decoder 2, confidence regularisation,
``filter_vertex_with_segmentation``), with the JAX package's initial weights
carried across.

* On ONE network output, the gradients of the losses (LS voting in its
  einsum form, the keypoint loss, the composite loss) with respect to that
  output agree with JAX's to rtol 1e-4 of each part's max |g|.
* Through the network, float32 itself sets the floor: the JAX package's own
  parameter gradient is up to 5.7e-4 of a tensor's max |g| away from the
  exact one (the port run in float64), the port's up to 2.6e-4. Both, and
  their difference, are held at 1e-3 of each tensor's max |g|.
* A predicted direction of exactly zero gives a non-finite gradient at that
  pixel in both packages, and the same gradient everywhere else.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_parity import (
    gradient_errors,
    jax_grads,
    jax_train_variables,
    port_grads,
    single_torch_thread,  # noqa: F401 (autouse)
    step_configs,
    synthetic_train_batch,
)

OC, K, B, H, W = 2, 3, 2, 32, 32


@pytest.fixture(scope="module")
def case():
    from casapose_tpu.core.checkpoint import flatten_params

    jax_model, variables = jax_train_variables(H, W, OC, K)
    return jax_model, variables, flatten_params(variables), synthetic_train_batch(B, H, W, OC, K)


def _loss_weights(**kw):
    from casapose_tpu.losses.losses import LossWeights as JaxLossWeights
    from casapose_tpu_torch.losses.losses import LossWeights

    fields = dict(filter_vertex_with_segmentation=True, **kw)
    return JaxLossWeights(**fields), LossWeights(**fields)


def test_forward_and_loss_gradient_without_bpnp(case):
    jax_model, variables, flat, batch = case
    jcfg, pcfg = step_configs(OC, K)
    jlw, plw = _loss_weights()
    jl, gj = jax_grads(jax_model, variables, batch, jcfg, jlw)
    pl, gp = port_grads(flat, batch, pcfg, plw)
    el, g64 = port_grads(flat, batch, pcfg, plw, double=True)
    np.testing.assert_allclose(pl, jl, rtol=2e-5)
    np.testing.assert_allclose(pl, el, rtol=2e-5)
    assert set(gp) == set(gj)
    for name, err in (("port vs float64", gradient_errors(gp, g64)), ("jax vs float64", gradient_errors(gj, g64)),
                      ("port vs jax", gradient_errors(gp, gj))):
        worst = max(err, key=err.get)
        assert err[worst] <= 1e-3, f"{name}: {worst} off by {err[worst]:.3g} of its max |g|"


def _output_and_inputs(seed=1):
    """One seeded network output [b, h, w, 1 + oc + 3k] and the step's GT tensors for it (numpy)."""
    rng = np.random.default_rng(seed)
    batch = synthetic_train_batch(B, H, W, OC, K)
    out = rng.normal(size=(B, H, W, 1 + OC + 3 * K)).astype(np.float32)
    labels = batch["seg"][..., 0].astype(np.int64)
    target_seg = (labels[..., None] == np.arange(OC + 1)).astype(np.float32)
    return out, target_seg, batch


def _jax_losses(out, target_seg, batch, lw, kp_weight_only=False):
    from casapose_tpu.losses.losses import composite_loss, keypoint_reprojection_loss
    from casapose_tpu.ops.vectorfield import get_all_vectorfields
    from casapose_tpu.ops.voting import ls_voting

    seg_dim = OC + 1
    seg, dirs, conf = out[..., :seg_dim], out[..., seg_dim : seg_dim + 2 * K], out[..., seg_dim + 2 * K :]
    tseg = jnp.asarray(target_seg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    coords = ls_voting(tseg, dirs, conf, num_points=K)
    kp, _, _ = keypoint_reprojection_loss(coords, seg, jb["poses_gt"], jb["keypoints3d"], tseg, jb["camera"],
                                          jb["offsets"], conf, max_pixel_error=12.5, min_num=50,
                                          confidence_regularization=True)
    target_dirs = get_all_vectorfields(tseg, jb["keypoints2d"], jb["seg"], False)
    losses = composite_loss(seg, tseg, dirs, target_dirs, jb["keypoints2d"], lw, filtered_seg=jb["seg"],
                            pixel_gt_count=jb["pixel_gt_count"], kp_loss=kp)
    return losses[0]


def _port_losses(out, target_seg, batch, lw):
    from casapose_tpu_torch.losses.losses import composite_loss, keypoint_reprojection_loss
    from casapose_tpu_torch.ops.vectorfield import get_all_vectorfields
    from casapose_tpu_torch.ops.voting import ls_voting
    from casapose_tpu_torch.train import device_batch

    seg_dim = OC + 1
    seg, dirs, conf = out[..., :seg_dim], out[..., seg_dim : seg_dim + 2 * K], out[..., seg_dim + 2 * K :]
    tseg = torch.from_numpy(target_seg)
    tb = device_batch(batch, "cpu")
    coords = ls_voting(tseg, dirs, conf, num_points=K)
    kp, _, _ = keypoint_reprojection_loss(coords, seg, tb["poses_gt"], tb["keypoints3d"], tseg, tb["camera"],
                                          tb["offsets"], conf, max_pixel_error=12.5, min_num=50,
                                          confidence_regularization=True)
    target_dirs = get_all_vectorfields(tseg, tb["keypoints2d"], tb["seg"], False)
    losses = composite_loss(seg, tseg, dirs, target_dirs, tb["keypoints2d"], lw, filtered_seg=tb["seg"],
                            pixel_gt_count=tb["pixel_gt_count"], kp_loss=kp)
    return losses[0]


def _both_gradients(out, target_seg, batch, **kw):
    jlw, plw = _loss_weights(**kw)
    gj = np.asarray(jax.grad(lambda o: _jax_losses(o, target_seg, batch, jlw))(jnp.asarray(out)))
    o = torch.tensor(out, requires_grad=True)
    _port_losses(o, target_seg, batch, plw).backward()
    return gj, o.grad.numpy()


@pytest.mark.parametrize("filter_high_proxy_errors", [False, True], ids=["keep-all", "keep-mask"])
def test_loss_gradients_on_one_network_output(filter_high_proxy_errors):
    """Seg, direction and confidence gradients of voting + keypoint loss + composite loss, rtol 1e-4 of each max."""
    out, target_seg, batch = _output_and_inputs()
    gj, gp = _both_gradients(out, target_seg, batch, filter_high_proxy_errors=filter_high_proxy_errors,
                             kp_loss_weight=0.5)
    for part in (slice(0, OC + 1), slice(OC + 1, OC + 1 + 2 * K), slice(OC + 1 + 2 * K, None)):
        scale = np.abs(gj[..., part]).max()
        assert scale > 0
        np.testing.assert_allclose(gp[..., part], gj[..., part], rtol=0, atol=1e-4 * scale)


def test_zero_direction_gives_the_same_non_finite_gradient():
    """An exactly zero predicted direction: non-finite at that pixel in both (sqrt'(0) in the norm), equal elsewhere."""
    out, target_seg, batch = _output_and_inputs(seed=2)
    y, x = 5, 7
    out[0, y, x, OC + 1 : OC + 3] = 0.0  # keypoint 0's direction at one foreground pixel
    assert target_seg[0, y, x, 0] == 0.0
    gj, gp = _both_gradients(out, target_seg, batch, kp_loss_weight=0.5)
    bad_j, bad_p = ~np.isfinite(gj), ~np.isfinite(gp)
    assert bad_j.any()
    np.testing.assert_array_equal(bad_p, bad_j)
    assert bad_j[0, y, x].any() and not bad_j[1].any()
    scale = np.abs(gj[~bad_j]).max()
    np.testing.assert_allclose(gp[~bad_p], gj[~bad_j], rtol=0, atol=1e-4 * scale)
