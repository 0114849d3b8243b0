"""The bfloat16 compute dtype of the port against the JAX package's ``dtype=jnp.bfloat16`` policy, on the CPU.

The port copies flax's cast points (models/layers.py): parameters stay
float32, a conv casts its input and kernel to bfloat16, BatchNorm computes
in float32 and rounds its result, CLADE rounds gamma * x + beta term by
term, the upsamplers sum in bfloat16, and the seg logits and vertex output
are float32.

Tolerances, and why:
  * each layer alone, on the same bfloat16 input: the layers without a
    contraction (BatchNorm, CLADE, leaky ReLU, the upsamplers, the 2x
    resize) round the same float32 values in the same places as XLA does
    (per op, checked under ``jax.jit``), so their outputs are equal bit for
    bit. A convolution sums in float32 in another order (XLA-CPU against
    oneDNN) before its one rounding, so an output may round to the
    neighbouring bfloat16 value: at most 1 ulp (|d| <= 2^-7 |y|, as a
    bfloat16 has 8 significant bits); the partial conv sums its 9 rounded
    taps in bfloat16: a few ulps of the output's scale;
  * inside the model: XLA keeps a convolution's float32 result for the
    BatchNorm or CLADE that follows it (excess precision: it drops the
    round trip to bfloat16 that flax's cast points imply), where the port,
    like cuDNN, rounds the conv output first. One more rounding per layer
    makes the port's bfloat16 error about 1.25x the JAX package's (measured
    at every layer of casapose_c_gcu5: 1.10x after the first BatchNorm,
    1.22-1.29x from the first residual block on). No elementwise tolerance
    fits that, so each package's bfloat16 output is held against its own
    float32 output: the port's mean bfloat16 error may be at most 1.5x the
    JAX package's at every layer and at the output, its largest error 2x
    (a tail statistic); and the two bfloat16 outputs may differ on average
    by at most twice the JAX package's mean error (independent roundings of
    one computation). ``gt_seg`` is given (decoder 2 conditioned on the GT),
    so that no label depends on a rounding;
  * with predicted masks: the share of pixels whose predicted label differs
    between the two packages' bfloat16 runs may be at most twice the share
    that differs between the JAX package's bfloat16 and float32 runs, plus
    0.5%: near-ties of the seg logits flip under any rounding, and each flip
    changes that pixel's masks downstream.
"""

import numpy as np
import pytest

from tests.torch_parity import calibrated_variables

ULP = 2.0**-7  # relative spacing of bfloat16 values (8 significant bits)


def _bf16(x):
    import jax.numpy as jnp

    return jnp.asarray(x).astype(jnp.bfloat16)


def _nchw16(x):
    import torch

    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32).transpose(0, 3, 1, 2))).to(torch.bfloat16)


def _nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def _f32(x):
    return np.asarray(x.astype(np.float32) if hasattr(x, "astype") else x, np.float32)


def _jit_apply(module, variables, *args, **kwargs):
    """``module.apply`` under ``jax.jit`` on jax arrays, as the model runs it."""
    import jax
    import jax.numpy as jnp

    variables = jax.tree_util.tree_map(jnp.asarray, variables)
    args = [None if a is None else jnp.asarray(a) for a in args]
    return jax.jit(lambda v, *a: module.apply(v, *a, **kwargs))(variables, *args)


def _onehot(rng, b, h, w, c):
    lab = rng.integers(0, c, (b, h, w))
    lab[:, : h // 3] = 0
    return (lab[..., None] == np.arange(c)).astype(np.float32)


def test_conv_and_batch_norm():
    import flax.linen as fnn
    import jax
    import torch

    from casapose_tpu.models.layers import batch_norm

    from casapose_tpu_torch.models.layers import BatchNorm, Conv

    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 12, 10, 16)).astype(np.float32)
    jc = fnn.Conv(8, (3, 3), padding=[(1, 1), (1, 1)], use_bias=False, dtype=jax.numpy.bfloat16)
    variables = jc.init(jax.random.PRNGKey(0), x)
    want = _f32(jax.jit(jc.apply)(variables, x))
    conv = Conv(16, 8, 3, padding=1, dtype=torch.bfloat16)
    with torch.no_grad():
        conv.weight.copy_(torch.tensor(np.asarray(variables["params"]["kernel"]).transpose(3, 2, 0, 1)))
        got = conv(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    assert got.dtype == torch.bfloat16
    assert (np.abs(_nhwc(got) - want) <= ULP * np.abs(want) + 1e-6).all()  # at most one bfloat16 step

    jb = batch_norm("bn", dtype=jax.numpy.bfloat16)
    stats = {"mean": rng.normal(size=8).astype(np.float32), "var": rng.uniform(0.5, 2, 8).astype(np.float32)}
    params = {"scale": rng.normal(size=8).astype(np.float32), "bias": rng.normal(size=8).astype(np.float32)}
    xb = _bf16(want)
    want_bn = _f32(_jit_apply(jb, {"params": params, "batch_stats": stats}, xb, use_running_average=True))
    bn = BatchNorm(8, dtype=torch.bfloat16).eval()
    with torch.no_grad():
        for name, v in (("weight", "scale"), ("bias", "bias")):
            getattr(bn, name).copy_(torch.from_numpy(params[v]))
        bn.running_mean.copy_(torch.from_numpy(stats["mean"]))
        bn.running_var.copy_(torch.from_numpy(stats["var"]))
        got_bn = bn(_nchw16(_f32(xb)))
    assert got_bn.dtype == torch.bfloat16
    np.testing.assert_array_equal(_nhwc(got_bn), want_bn)


def test_clade_and_activations():
    import flax.linen as fnn
    import jax
    import torch

    from casapose_tpu.models.layers import ClassAdaptiveWeightedNorm as JaxCLADE

    from casapose_tpu_torch.models.layers import ClassAdaptiveWeightedNorm, leaky_relu

    rng = np.random.default_rng(1)
    x = _bf16(rng.normal(size=(2, 6, 7, 5)))
    onehot = _onehot(rng, 2, 6, 7, 3)
    params = {"gamma": rng.normal(size=(3, 5)).astype(np.float32), "beta": rng.normal(size=(3, 5)).astype(np.float32)}
    stats = {"mean": rng.normal(size=5).astype(np.float32), "var": rng.uniform(0.5, 2.0, 5).astype(np.float32)}
    jm = JaxCLADE(num_classes=3, dtype=jax.numpy.bfloat16)
    want = _f32(_jit_apply(jm, {"params": params, "batch_stats": {"bn": stats}}, x, onehot, use_running_average=True))
    norm = ClassAdaptiveWeightedNorm(3, 5, dtype=torch.bfloat16).eval()
    with torch.no_grad():
        norm.gamma.copy_(torch.from_numpy(params["gamma"]))
        norm.beta.copy_(torch.from_numpy(params["beta"]))
        norm.bn.running_mean.copy_(torch.from_numpy(stats["mean"]))
        norm.bn.running_var.copy_(torch.from_numpy(stats["var"]))
        got = norm(_nchw16(_f32(x)), _nchw16(onehot).float())
    np.testing.assert_array_equal(_nhwc(got), want)
    want = _f32(jax.jit(lambda x: fnn.leaky_relu(x, negative_slope=0.1))(x))
    np.testing.assert_array_equal(_nhwc(leaky_relu(_nchw16(_f32(x)))), want)


def test_partial_conv():
    import jax
    import torch

    from casapose_tpu.models.layers import PartialConv as JaxPartialConv

    from casapose_tpu_torch.models.layers import PartialConv

    rng = np.random.default_rng(2)
    x = _bf16(rng.normal(size=(2, 12, 10, 6)))
    onehot = _onehot(rng, 2, 12, 10, 3)
    jm = JaxPartialConv(features=5, num_classes=3)
    variables = jm.init(jax.random.PRNGKey(0), x, onehot)
    pc = PartialConv(6, 5)
    with torch.no_grad():
        pc.weight.copy_(torch.tensor(np.asarray(variables["params"]["kernel"]).transpose(3, 2, 0, 1)))
    for mask in (None, onehot):
        want = _f32(_jit_apply(jm, variables, x, mask))
        got = pc(_nchw16(_f32(x)), None if mask is None else _nchw16(mask).float())
        assert got.dtype == torch.bfloat16
        scale = np.abs(want).max()
        # the 9 taps each round once and are summed in bfloat16: a few ulps of the output's scale
        assert np.abs(_nhwc(got) - want).max() <= 4 * ULP * scale, (mask is None, np.abs(_nhwc(got) - want).max())


def test_upsamplers():
    import jax

    from casapose_tpu.models.layers import guided_bilinear_upsampling as jax_gbu
    from casapose_tpu.models.layers import guided_upsampling as jax_gu

    from casapose_tpu_torch.models.layers import guided_bilinear_upsampling, guided_upsampling, resize_bilinear_2x

    rng = np.random.default_rng(3)
    x = _bf16(rng.normal(size=(2, 6, 8, 4)))
    lo, hi = _onehot(rng, 2, 6, 8, 3), _onehot(rng, 2, 12, 16, 3)
    for jf, tf in ((jax_gu, guided_upsampling), (jax_gbu, guided_bilinear_upsampling)):
        want = _f32(jax.jit(jf)(x, jax.numpy.asarray(lo), jax.numpy.asarray(hi)))
        np.testing.assert_array_equal(_nhwc(tf(_nchw16(_f32(x)), _nchw16(lo), _nchw16(hi))), want)
    want = _f32(jax.jit(lambda x: jax.image.resize(x, (2, 12, 16, 4), method="bilinear"))(x))
    np.testing.assert_array_equal(_nhwc(resize_bilinear_2x(_nchw16(_f32(x)))), want)


def _models(name, img, vd, seg_dim):
    """(JAX float32 model, JAX bfloat16 model, flat variables, port float32 model, port bfloat16 model)."""
    import jax.numpy as jnp

    from casapose_tpu.models.registry import get_model as jax_get_model

    from casapose_tpu_torch.core.convert import from_jax_variables
    from casapose_tpu_torch.models.registry import get_model

    j32 = jax_get_model(name, ver_dim=vd, seg_dim=seg_dim)
    j16 = jax_get_model(name, ver_dim=vd, seg_dim=seg_dim, dtype=jnp.bfloat16)
    flat = calibrated_variables(j32, img)
    ports = []
    for dtype in ("float32", "bfloat16"):
        m = get_model(name, vd, seg_dim, device="cpu", dtype=dtype)
        m.load_state_dict(from_jax_variables(flat, m))
        ports.append(m)
    return j32, j16, flat, ports[0], ports[1]


def _outputs(name, gt):
    import jax
    import torch

    from casapose_tpu.core.checkpoint import unflatten_params

    b, h, w, oc, k = 2, 64, 64, 2, 3
    rng = np.random.default_rng(4)
    img = rng.normal(size=(b, h, w, 3)).astype(np.float32)
    args = (img,) + ((_onehot(rng, b, h, w, oc + 1),) if gt else ())
    j32, j16, flat, t32, t16 = _models(name, img, 3 * k, oc + 1)
    variables = unflatten_params(flat)
    apply = lambda m: np.asarray(jax.jit(lambda v, *a: m.apply(v, *a, train=False))(variables, *args))  # noqa: E731
    with torch.no_grad():
        got16, got32 = (m(*(torch.from_numpy(a) for a in args)) for m in (t16, t32))
    assert got16.dtype == torch.float32  # seg logits and vertex output are float32
    return got16.numpy(), got32.numpy(), apply(j16), apply(j32), oc + 1


def _errors(port16, port32, jax16, jax32):
    port_err, jax_err = np.abs(port16 - port32), np.abs(jax16 - jax32)
    return port_err.mean(), jax_err.mean(), port_err.max(), jax_err.max()


@pytest.mark.parametrize("name", ["casapose_c_gcu5", "pvnet"])
def test_model_with_gt_seg(name):
    got16, got32, want16, want32, _ = _outputs(name, gt=True)
    np.testing.assert_allclose(got32, want32, rtol=1e-4, atol=1e-4)
    port_mean, jax_mean, port_max, jax_max = _errors(got16, got32, want16, want32)
    assert port_max > 0  # the policy took effect
    assert port_mean <= 1.5 * jax_mean and port_max <= 2 * jax_max, (port_mean, jax_mean, port_max, jax_max)
    assert np.abs(got16 - want16).mean() <= 2 * jax_mean, (np.abs(got16 - want16).mean(), jax_mean)


def test_model_layer_by_layer():
    """Every layer of casapose_c_gcu5 in bfloat16 (flax's captured module outputs against the port's, through
    forward hooks), each package against its own float32 run (see the module docstring)."""
    import jax
    import torch

    from casapose_tpu.core.checkpoint import unflatten_params

    rng = np.random.default_rng(4)
    img = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    gt = _onehot(rng, 2, 64, 64, 3)
    j32, j16, flat, t32, t16 = _models("casapose_c_gcu5", img, 9, 3)
    variables = unflatten_params(flat)

    def captured(m):
        _, state = jax.jit(lambda v, x, g: m.apply(v, x, g, train=False, capture_intermediates=True,
                                                   mutable=["intermediates"]))(variables, img, gt)
        return state["intermediates"]

    def hooked(model):
        acts = {}

        def keep(name):
            def hook(module, inputs, output):
                if isinstance(output, torch.Tensor):
                    acts[name] = output.float().numpy()
            return hook

        for name, mod in model.named_modules():
            if name and not name.startswith("segmentation_"):
                mod.register_forward_hook(keep(name))
        with torch.no_grad():
            model(torch.from_numpy(img), torch.from_numpy(gt))
        return acts

    jax_acts = [captured(m) for m in (j16, j32)]
    port16, port32 = hooked(t16), hooked(t32)
    checked = 0
    for name in port16:
        tree = [a for a in jax_acts]
        for part in name.split("."):
            tree = [t.get(part, {}) for t in tree]
        if "__call__" not in tree[0]:
            continue  # a flax submodule called inside another (CLADE's bn) or not captured
        j16_out, j32_out = (np.asarray(t["__call__"][0], np.float32) for t in tree)
        t16_out, t32_out = (a[name].transpose(0, 2, 3, 1) for a in (port16, port32))
        port_mean, jax_mean, port_max, jax_max = _errors(t16_out, t32_out, j16_out, j32_out)
        assert port_mean <= 1.5 * jax_mean + 1e-6 and port_max <= 2 * jax_max + 1e-6, (
            name, port_mean, jax_mean, port_max, jax_max)
        checked += 1
    assert checked >= 60, checked  # 67: the backbone's convs and BatchNorms, every decoder layer, the output convs


def test_model_with_predicted_masks():
    got16, _, want16, want32, seg_dim = _outputs("casapose_c_gcu5", gt=False)
    labels = [x[..., :seg_dim].argmax(-1) for x in (got16, want16, want32)]
    flips, jax_flips = (labels[0] != labels[1]).mean(), (labels[1] != labels[2]).mean()
    assert flips <= 2 * jax_flips + 0.005, (flips, jax_flips)
    assert np.isfinite(got16).all()
