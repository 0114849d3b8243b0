"""The port's train step (``build_train_step``: forward, backward, ``AdamTF``) against the JAX one, on the CPU.

``__graft_entry__.py::build_synthetic_train_case``'s step (casapose_c_gcu5,
2 objects, 3 keypoints, 32x32, batch 2, noise 1e-4, with the JAX package's
own noise draws for each step's key handed to the port) from the same
initial weights, under the reference's piecewise schedule with its
boundary at step 0 (``e * batches - 1`` for epoch 1 of 1 batch: lr 5e-4
from the first update):

* the first loss row (before any update) agrees to rtol 1e-4; the rows of
  steps 2 and 3 to rtol 1e-3, their keypoint loss to rtol 1e-2: float32
  gradients differ by up to 1e-3 of a tensor's max
  (tests/test_torch_train_grads.py), the first Adam steps move every weight
  by about lr times the sign of its gradient, so weights whose gradient is
  near zero move apart by up to 2 lr, and the voted keypoints are the most
  sensitive output (measured at step 3: keypoint 4.6e-3, vertex 1.05e-4,
  total 3e-5);
* after one step, every weight lies within what the first AdamTF update
  makes of a gradient 1e-3 of its tensor's max away (the gradients'
  agreement), plus two float32 ulps of the weight; the running statistics
  agree to rtol 1e-5 of each tensor's max.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from tests.torch_parity import jax_train_variables, port_train_model, step_configs, synthetic_train_batch
from tests.torch_parity import single_torch_thread  # noqa: F401 (autouse)

OC, K, B, H, W = 2, 3, 2, 32, 32
LR = (1e-3, 0.5, 15, 0, [1], 1)  # make_lr_schedule args: its boundary at step 0


def _jax_noise_draws(key, shape, noise):
    kk = jax.random.split(key, 2)[1]
    return {"noise_std": torch.from_numpy(np.array(jax.random.uniform(kk, (1,), minval=0.0, maxval=noise))),
            "noise": torch.from_numpy(np.array(jax.random.normal(jax.random.fold_in(kk, 1), shape)))}


def test_train_step_against_jax():
    from casapose_tpu.core.checkpoint import flatten_params
    from casapose_tpu.core.optimizer import adam_tf
    from casapose_tpu.losses.losses import LossWeights as JaxLossWeights
    from casapose_tpu.losses.schedules import make_lr_schedule as jax_schedule
    from casapose_tpu.train import TrainState
    from casapose_tpu.train import build_train_step as jax_build_train_step
    from casapose_tpu_torch.core.convert import from_jax_variables
    from casapose_tpu_torch.core.optimizer import AdamTF
    from casapose_tpu_torch.losses.losses import LossWeights
    from casapose_tpu_torch.losses.schedules import make_lr_schedule
    from casapose_tpu_torch.train import build_train_step, device_batch

    jax_model, variables = jax_train_variables(H, W, OC, K)
    flat = flatten_params(variables)
    jcfg, pcfg = step_configs(OC, K, noise=1e-4)
    lw = dict(filter_vertex_with_segmentation=True)
    batch = synthetic_train_batch(B, H, W, OC, K)

    tx = adam_tf(jax_schedule(*LR))
    state = TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]), step=jnp.zeros([], jnp.int32))
    jstep = jax_build_train_step(jax_model, tx, jcfg, JaxLossWeights(**lw))
    model = port_train_model(flat, OC, K)
    opt = AdamTF(model.parameters(), make_lr_schedule(*LR))
    pstep = build_train_step(model, opt, pcfg, LossWeights(**lw))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = device_batch(batch, "cpu")

    rows_j, rows_p = [], []
    for i in range(3):
        key = jax.random.PRNGKey(10 + i)
        state, lj = jstep(state, jb, key)
        rows_j.append(np.asarray(lj))
        rows_p.append(pstep(tb, draws=_jax_noise_draws(key, batch["img"].shape, 1e-4)).numpy())
        if i == 0:
            grads = {n: p.grad.numpy().copy() for n, p in model.named_parameters()}
            after_j = from_jax_variables(flatten_params({"params": state.params, "batch_stats": state.batch_stats}))
            after_p = {n: v.clone() for n, v in model.state_dict().items()}
    rows_p, rows_j = np.array(rows_p), np.array(rows_j)
    np.testing.assert_allclose(rows_p[0], rows_j[0], rtol=1e-4)
    np.testing.assert_allclose(rows_p[1:, :4], rows_j[1:, :4], rtol=1e-3)
    np.testing.assert_allclose(rows_p[1:, 4], rows_j[1:, 4], rtol=1e-2)
    assert rows_p[2][0] < rows_p[0][0]

    # A first AdamTF step moves a weight by u(g) = -lr g / (|g| + eps / sqrt(1 - b2)), monotone in g.
    lr = float(make_lr_schedule(*LR)(0))

    def u(g):
        return -lr * g / (np.abs(g) + 1e-7 / np.sqrt(1.0 - 0.999))

    for name, ref in after_j.items():
        ref, got = ref.numpy(), after_p[name].numpy()
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max(), err_msg=name)
            continue
        g = grads[name].astype(np.float64)
        delta = 1e-3 * np.abs(g).max()  # the gradients' agreement, tests/test_torch_train_grads.py
        bound = np.maximum(np.abs(u(g + delta) - u(g)), np.abs(u(g - delta) - u(g))) + 2 * np.spacing(np.abs(ref))
        assert np.all(np.abs(got - ref) <= bound), name
