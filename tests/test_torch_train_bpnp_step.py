"""The train step's parameter gradient through BPnP against ``jax.grad``, on the CPU.

``use_bpnp_reprojection_loss 1`` on casapose_c_gcu5 (2 objects, 9
keypoints: three points leave P3P's several solutions), 32x32, batch 2, with
PnP problems planted well-posed for the points the step votes (each object's
model keypoints put where a pose projects them within 0.05 px of its voted
points, ``tests/torch_parity.py::plant_train_keypoints``) and the JAX solve
down its accelerator branch (the Pallas PnP kernel in interpret mode, the
algorithm the port's kernel runs). Float32 sets the floor: the JAX package's
gradient is 2.0e-4 and the port's 3.5e-4 of a tensor's max |g| from the
port's float64 run, so both and their difference are held at 1e-3.
"""

import numpy as np

from tests.torch_parity import (
    gradient_errors,
    jax_grads,
    jax_pnp_accelerator_branch,
    jax_train_variables,
    plant_train_keypoints,
    port_grads,
    single_torch_thread,  # noqa: F401 (autouse)
    step_configs,
    synthetic_train_batch,
    train_mode_votes,
)


def test_forward_and_loss_gradient_with_bpnp():
    from casapose_tpu.core.checkpoint import flatten_params
    from casapose_tpu.losses.losses import LossWeights as JaxLossWeights
    from casapose_tpu_torch.losses.losses import LossWeights

    oc, k, b, h, w = 2, 9, 2, 32, 32
    jax_model, variables = jax_train_variables(h, w, oc, k)
    flat = flatten_params(variables)
    jcfg, pcfg = step_configs(oc, k, use_bpnp_reprojection_loss=True)
    batch = synthetic_train_batch(b, h, w, oc, k)
    batch = plant_train_keypoints(batch, train_mode_votes(flat, batch, pcfg))
    lw = dict(filter_vertex_with_segmentation=True)
    with jax_pnp_accelerator_branch() as calls:
        jl, gj = jax_grads(jax_model, variables, batch, jcfg, JaxLossWeights(**lw))
    assert calls, "the JAX solve did not take its Pallas branch"
    pl, gp = port_grads(flat, batch, pcfg, LossWeights(**lw))
    el, g64 = port_grads(flat, batch, pcfg, LossWeights(**lw), double=True)
    np.testing.assert_allclose(pl, jl, rtol=2e-5)
    np.testing.assert_allclose(pl, el, rtol=2e-5)
    for name, err in (("port vs float64", gradient_errors(gp, g64)), ("jax vs float64", gradient_errors(gj, g64)),
                      ("port vs jax", gradient_errors(gp, gj))):
        worst = max(err, key=err.get)
        assert err[worst] <= 1e-3, f"{name}: {worst} off by {err[worst]:.3g} of its max |g|"
