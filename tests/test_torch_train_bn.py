"""BatchNorm with batch statistics (training mode) against flax 0.12's, on the CPU.

* One layer, of both kinds the models hold (with scale and bias, and
  CLADE's parameter-free one), in float32 and with a bfloat16 compute dtype:
  outputs, the updated running statistics (rtol 1e-5) and the gradients with
  respect to the input and the parameters (rtol 1e-5 of each max |g|) agree;
  bfloat16 outputs within one bfloat16 rounding (2^-8 relative).
* The whole casapose_c_gcu5 in training mode (32x32, batch 2, 2 objects,
  3 keypoints, GT masks): the output (rtol 1e-4 of its max) and every
  updated running statistic (rtol 1e-5 of each tensor's max) agree.
"""

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp

from tests.torch_parity import jax_train_variables, port_train_model, synthetic_train_batch
from tests.torch_parity import single_torch_thread  # noqa: F401 (autouse)

C = 16


def _flax_bn(center, scale, dtype):
    from casapose_tpu.models.layers import BN_EPS, BN_MOMENTUM

    return nn.BatchNorm(use_running_average=False, momentum=BN_MOMENTUM, epsilon=BN_EPS, use_bias=center,
                        use_scale=scale, dtype=dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("center_scale", [True, False], ids=["scale-bias", "clade"])
def test_batch_norm_layer_in_training(dtype, center_scale):
    from casapose_tpu_torch.models.layers import BatchNorm

    rng = np.random.default_rng(0)
    x = (3.0 + 2.0 * rng.normal(size=(2, 6, 5, C))).astype(np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)
    scale, bias = rng.uniform(0.5, 1.5, C).astype(np.float32), rng.normal(size=C).astype(np.float32)
    ra_mean, ra_var = rng.normal(size=C).astype(np.float32), rng.uniform(0.5, 2, C).astype(np.float32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (None, None)

    bn = _flax_bn(center_scale, center_scale, jdt)
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)} if center_scale else {}
    stats = {"mean": jnp.asarray(ra_mean), "var": jnp.asarray(ra_var)}
    xj = jnp.asarray(x).astype(jdt) if jdt else jnp.asarray(x)

    def f(p, xin):
        y, upd = bn.apply({"params": p, "batch_stats": stats}, xin, mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * cot), (y, upd["batch_stats"])

    (gp, gx), (yj, sj) = jax.grad(f, argnums=(0, 1), has_aux=True)(params, xj)

    layer = BatchNorm(C, center=center_scale, scale=center_scale, dtype=tdt).train()
    with torch.no_grad():
        layer.running_mean.copy_(torch.from_numpy(ra_mean))
        layer.running_var.copy_(torch.from_numpy(ra_var))
        if center_scale:
            layer.weight.copy_(torch.from_numpy(scale))
            layer.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(x).to(tdt or torch.float32).permute(0, 3, 1, 2).detach().requires_grad_()
    yt = layer(xt)
    (yt.float() * torch.from_numpy(cot).permute(0, 3, 1, 2)).sum().backward()

    y_port = yt.detach().float().permute(0, 2, 3, 1).numpy()
    y_ref = np.asarray(yj.astype(jnp.float32))
    if dtype == "bfloat16":
        assert yt.dtype == torch.bfloat16 and yj.dtype == jnp.bfloat16
        np.testing.assert_allclose(y_port, y_ref, rtol=2.0**-8, atol=2.0**-8 * np.abs(y_ref).max() * 1e-2)
    else:
        np.testing.assert_allclose(y_port, y_ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(layer.running_mean.numpy(), np.asarray(sj["mean"]), rtol=1e-5)
    np.testing.assert_allclose(layer.running_var.numpy(), np.asarray(sj["var"]), rtol=1e-5)
    grads = [(xt.grad.float().permute(0, 2, 3, 1).numpy(), np.asarray(gx.astype(jnp.float32)))]
    if center_scale:
        grads += [(layer.weight.grad.numpy(), np.asarray(gp["scale"])), (layer.bias.grad.numpy(), np.asarray(gp["bias"]))]
    for port, ref in grads:
        tol = 2.0**-7 if dtype == "bfloat16" and port.shape == x.shape else 1e-5  # the input's gradient is bf16
        np.testing.assert_allclose(port, ref, rtol=0, atol=tol * np.abs(ref).max())


def test_model_in_training_mode_updates_batch_stats_as_flax():
    from casapose_tpu.core.checkpoint import flatten_params
    from casapose_tpu_torch.core.convert import from_jax_variables
    from casapose_tpu_torch.data.pipeline import prepare_device_batch

    oc, k, b, h, w = 2, 3, 2, 32, 32
    jax_model, variables = jax_train_variables(h, w, oc, k)
    batch = synthetic_train_batch(b, h, w, oc, k)
    img, tseg = prepare_device_batch(torch.from_numpy(batch["img"]), torch.from_numpy(batch["seg"]), oc + 1)
    apply = jax.jit(lambda v, x, g: jax_model.apply(v, x, g, train=True, mutable=["batch_stats"]))
    out_j, upd = apply(variables, jnp.asarray(img.numpy()), jnp.asarray(tseg.numpy()))
    model = port_train_model(flatten_params(variables), oc, k).train()
    with torch.no_grad():
        out_p = model(img, tseg).numpy()
    out_j = np.asarray(out_j)
    np.testing.assert_allclose(out_p, out_j, rtol=0, atol=1e-4 * np.abs(out_j).max())
    ref = from_jax_variables(flatten_params({"batch_stats": upd["batch_stats"]}))
    state = model.state_dict()
    assert len(ref) == 2 * sum(1 for n in state if n.endswith("running_mean"))
    for name, v in ref.items():
        np.testing.assert_allclose(state[name].numpy(), v.numpy(), rtol=0, atol=1e-5 * np.abs(v.numpy()).max(),
                                   err_msg=name)
