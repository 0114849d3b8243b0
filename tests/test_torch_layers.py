"""casapose_tpu_torch layers and numerics against casapose_tpu on the CPU.

The JAX layers take NHWC, the port's take NCHW; inputs come from numpy and
are transposed for the port. Tolerance: atol 1e-5 (float32 rounding of
3x3 convolutions over <= 16 channels); selections and one-hots are exact.
"""

import numpy as np
import pytest

ATOL = 1e-5


def _nchw(x):
    import torch

    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _logits_with_ties(rng, b=2, h=8, w=10, c=4):
    logits = rng.integers(0, 3, (b, h, w, c)).astype(np.float32)  # many equal maxima
    logits[:, :2] = 0.0  # whole rows of exact ties, as on the all-zero image
    return logits


def test_hard_onehot_first_max_on_ties():
    from casapose_tpu.models.layers import hard_onehot as jax_hard_onehot

    from casapose_tpu_torch.models.layers import hard_onehot

    logits = _logits_with_ties(np.random.default_rng(0))
    ref = np.asarray(jax_hard_onehot(logits))
    np.testing.assert_array_equal(_nhwc(hard_onehot(_nchw(logits), dim=1)), ref)
    assert (ref[:, :2, :, 0] == 1).all()


@pytest.mark.parametrize("masked", [False, True])
def test_partial_conv(masked):
    import jax
    import torch

    from casapose_tpu.models.layers import PartialConv as JaxPartialConv
    from casapose_tpu.models.layers import hard_onehot as jax_hard_onehot

    from casapose_tpu_torch.models.layers import PartialConv

    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 12, 10, 6)).astype(np.float32)
    onehot = np.asarray(jax_hard_onehot(_logits_with_ties(rng, h=12, w=10, c=3))) if masked else None
    jm = JaxPartialConv(features=5, num_classes=3)
    variables = jm.init(jax.random.PRNGKey(0), x, onehot)
    ref = np.asarray(jm.apply(variables, x, onehot))
    pc = PartialConv(6, 5)
    with torch.no_grad():
        pc.weight.copy_(torch.tensor(np.asarray(variables["params"]["kernel"]).transpose(3, 2, 0, 1)))
        out = pc(_nchw(x), _nchw(onehot) if masked else None)
    np.testing.assert_allclose(_nhwc(out), ref, atol=ATOL, rtol=0)


def test_clade_weighted_norm():
    import jax
    import torch

    from casapose_tpu.models.layers import ClassAdaptiveWeightedNorm as JaxCLADE
    from casapose_tpu.models.layers import hard_onehot as jax_hard_onehot

    from casapose_tpu_torch.models.layers import ClassAdaptiveWeightedNorm

    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 6, 7, 5)).astype(np.float32)
    onehot = np.asarray(jax_hard_onehot(_logits_with_ties(rng, h=6, w=7, c=3)))
    jm = JaxCLADE(num_classes=3)
    variables = jm.init(jax.random.PRNGKey(0), x, onehot, use_running_average=True)
    params = {"gamma": rng.normal(size=(3, 5)).astype(np.float32), "beta": rng.normal(size=(3, 5)).astype(np.float32)}
    stats = {"mean": rng.normal(size=5).astype(np.float32), "var": rng.uniform(0.5, 2.0, 5).astype(np.float32)}
    variables = {"params": params, "batch_stats": {"bn": stats}}
    ref = np.asarray(jm.apply(variables, x, onehot, use_running_average=True))
    norm = ClassAdaptiveWeightedNorm(3, 5).eval()
    with torch.no_grad():
        norm.gamma.copy_(torch.from_numpy(params["gamma"]))
        norm.beta.copy_(torch.from_numpy(params["beta"]))
        norm.bn.running_mean.copy_(torch.from_numpy(stats["mean"]))
        norm.bn.running_var.copy_(torch.from_numpy(stats["var"]))
        out = norm(_nchw(x), _nchw(onehot))
    np.testing.assert_allclose(_nhwc(out), ref, atol=ATOL, rtol=0)


def test_batch_norm_refuses_training_mode():
    """Training mode no longer raises: it normalises with the batch's statistics and updates the running ones
    (held against flax in tests/test_torch_train_bn.py)."""
    import torch

    from casapose_tpu_torch.models.layers import BatchNorm

    bn = BatchNorm(3).train()
    x = torch.arange(24, dtype=torch.float32).reshape(2, 3, 2, 2)
    y = bn(x)
    torch.testing.assert_close(y.mean(dim=(0, 2, 3)), torch.zeros(3), atol=1e-6, rtol=0)
    torch.testing.assert_close(bn.running_mean, 0.01 * x.mean(dim=(0, 2, 3)))


def test_guided_upsampling():
    from casapose_tpu.models.layers import guided_upsampling as jax_guided_upsampling
    from casapose_tpu.models.layers import hard_onehot as jax_hard_onehot

    from casapose_tpu_torch.models.layers import guided_upsampling

    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 6, 8, 4)).astype(np.float32)
    seg_lo = np.asarray(jax_hard_onehot(_logits_with_ties(rng, h=6, w=8, c=3)))
    seg_hi = np.asarray(jax_hard_onehot(_logits_with_ties(rng, h=12, w=16, c=3)))
    ref = np.asarray(jax_guided_upsampling(x, seg_lo, seg_hi))
    out = guided_upsampling(_nchw(x), _nchw(seg_lo), _nchw(seg_hi))
    np.testing.assert_array_equal(_nhwc(out), ref)  # a selection: exact


def test_half_size():
    import jax

    from casapose_tpu.models.layers import HalfSize

    from casapose_tpu_torch.models.layers import half_size

    x = np.random.default_rng(4).normal(size=(2, 7, 10, 3)).astype(np.float32)
    jm = HalfSize(depth=3)
    ref = np.asarray(jm.apply(jm.init(jax.random.PRNGKey(0), x), x))
    np.testing.assert_array_equal(_nhwc(half_size(_nchw(x))), ref)


@pytest.mark.parametrize("shape", [(2, 5, 7, 3), (1, 1, 4, 2)])
def test_bilinear_resize_2x_matches_jax_including_edges(shape):
    import jax

    from casapose_tpu_torch.models.layers import resize_bilinear_2x

    x = np.random.default_rng(5).normal(size=shape).astype(np.float32)
    b, h, w, c = shape
    ref = np.asarray(jax.image.resize(x, (b, 2 * h, 2 * w, c), method="bilinear"))
    out = _nhwc(resize_bilinear_2x(_nchw(x)))
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    # Edges: the outermost output rows / columns copy the outermost input rows / columns.
    np.testing.assert_allclose(out[:, 0, 0], x[:, 0, 0], atol=ATOL, rtol=0)
    np.testing.assert_allclose(out[:, -1, -1], x[:, -1, -1], atol=ATOL, rtol=0)


def test_numerics_match_jax():
    import torch

    from casapose_tpu.core import numerics as jn

    from casapose_tpu_torch.core.numerics import divide_no_nan, multiply_no_nan, safe_l2_normalize

    rng = np.random.default_rng(6)
    a = rng.normal(size=(4, 5)).astype(np.float32)
    b = rng.normal(size=(4, 5)).astype(np.float32)
    b[0] = 0.0
    a[1, 0] = np.inf
    b[1, 0] = 0.0
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_array_equal(divide_no_nan(ta, tb).numpy(), np.asarray(jn.divide_no_nan(a, b)))
    np.testing.assert_array_equal(multiply_no_nan(ta, tb).numpy(), np.asarray(jn.multiply_no_nan(a, b)))
    v = rng.normal(size=(3, 4, 2)).astype(np.float32)
    v[0, 0] = 0.0
    np.testing.assert_allclose(
        safe_l2_normalize(torch.from_numpy(v)).numpy(), np.asarray(jn.safe_l2_normalize(v)), atol=1e-7, rtol=0
    )


def test_f32_precision_guard_turns_tf32_off_and_restores():
    import torch

    from casapose_tpu_torch.core.numerics import f32_precision

    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with f32_precision():
            assert not torch.backends.cudnn.allow_tf32
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _bn_stats(rng, ch):
    return {"mean": rng.normal(size=ch).astype(np.float32), "var": rng.uniform(0.5, 2.0, ch).astype(np.float32)}


def _load_bn(bn, stats):
    import torch

    with torch.no_grad():
        bn.running_mean.copy_(torch.from_numpy(stats["mean"]))
        bn.running_var.copy_(torch.from_numpy(stats["var"]))


def test_clade_hard_labels():
    """``ClassAdaptiveNorm``: an integer label map selects the gamma/beta rows."""
    import torch

    from casapose_tpu.models.layers import ClassAdaptiveNorm as JaxNorm

    from casapose_tpu_torch.models.layers import ClassAdaptiveNorm

    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 6, 7, 5)).astype(np.float32)
    labels = rng.integers(0, 3, (2, 6, 7))
    params = {"gamma": rng.normal(size=(3, 5)).astype(np.float32), "beta": rng.normal(size=(3, 5)).astype(np.float32)}
    stats = _bn_stats(rng, 5)
    ref = np.asarray(JaxNorm(num_classes=3).apply({"params": params, "batch_stats": {"bn": stats}}, x, labels,
                                                  use_running_average=True))
    norm = ClassAdaptiveNorm(3, 5).eval()
    with torch.no_grad():
        norm.gamma.copy_(torch.from_numpy(params["gamma"]))
        norm.beta.copy_(torch.from_numpy(params["beta"]))
    _load_bn(norm.bn, stats)
    out = norm(_nchw(x), torch.from_numpy(labels))
    np.testing.assert_allclose(_nhwc(out), ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("learned_blend", [False, True])
def test_clade_with_input(learned_blend):
    """``ClassAdaptiveWeightedNormWithInput``: per-image gamma/beta [b, C, ch], optionally blended with learned ones."""
    import torch

    from casapose_tpu.models.layers import ClassAdaptiveWeightedNormWithInput as JaxNorm
    from casapose_tpu.models.layers import hard_onehot as jax_hard_onehot

    from casapose_tpu_torch.core.convert import from_jax_variables
    from casapose_tpu_torch.models.layers import ClassAdaptiveWeightedNormWithInput

    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 6, 7, 5)).astype(np.float32)
    onehot = np.asarray(jax_hard_onehot(_logits_with_ties(rng, h=6, w=7, c=3)))
    gamma_in, beta_in = (rng.normal(size=(2, 3, 5)).astype(np.float32) for _ in range(2))
    params = {}
    if learned_blend:
        params = {"gamma": rng.normal(size=(3, 5)).astype(np.float32), "beta": rng.normal(size=(3, 5)).astype(np.float32),
                  "alpha_1": np.array([0.3], np.float32), "alpha_2": np.array([1.7], np.float32)}  # 1.7 clips to 1
    stats = _bn_stats(rng, 5)
    jm = JaxNorm(num_classes=3, learned_blend=learned_blend)
    ref = np.asarray(jm.apply({"params": params, "batch_stats": {"bn": stats}}, x, onehot, gamma_in, beta_in,
                              use_running_average=True))
    norm = ClassAdaptiveWeightedNormWithInput(3, 5, learned_blend=learned_blend).eval()
    flat = {f"params/norm/{k}": v for k, v in params.items()}
    flat.update({f"batch_stats/norm/bn/{k}": v for k, v in stats.items()})
    holder = torch.nn.Module()
    holder.norm = norm
    holder.load_state_dict(from_jax_variables(flat, holder))  # the weight bridge maps alpha_1 / alpha_2 too
    out = norm(_nchw(x), _nchw(onehot), torch.from_numpy(gamma_in), torch.from_numpy(beta_in))
    np.testing.assert_allclose(_nhwc(out), ref, atol=ATOL, rtol=0)


def test_guided_bilinear_upsampling():
    from casapose_tpu.models.layers import guided_bilinear_upsampling as jax_gbu
    from casapose_tpu.models.layers import hard_onehot as jax_hard_onehot

    from casapose_tpu_torch.models.layers import guided_bilinear_upsampling

    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 6, 8, 4)).astype(np.float32)
    seg_lo = np.asarray(jax_hard_onehot(_logits_with_ties(rng, h=6, w=8, c=3)))
    seg_hi = np.asarray(jax_hard_onehot(_logits_with_ties(rng, h=12, w=16, c=3)))
    ref = np.asarray(jax_gbu(x, seg_lo, seg_hi))
    out = guided_bilinear_upsampling(_nchw(x), _nchw(seg_lo), _nchw(seg_hi))
    np.testing.assert_allclose(_nhwc(out), ref, atol=ATOL, rtol=0)
    # where all four candidates share the high-res label, it is plain 2x bilinear interpolation of the phase
    same = np.ones((2, 6, 8, 1), np.float32)
    plain = _nhwc(guided_bilinear_upsampling(_nchw(x), _nchw(same), _nchw(np.ones((2, 12, 16, 1), np.float32))))
    np.testing.assert_allclose(plain[:, 1:-1:2, 1:-1:2], (x[:, :-1, :-1] + x[:, :-1, 1:] + x[:, 1:, :-1] + x[:, 1:, 1:]) / 4,
                               atol=ATOL, rtol=0)


def test_trainable_half_size():
    """The trainable ``HalfSize`` (casapose_c): eye-initialised, and a trained matrix mixes the class channels."""
    import jax
    import torch

    from casapose_tpu.models.layers import HalfSize as JaxHalfSize

    from casapose_tpu_torch.core.convert import from_jax_variables
    from casapose_tpu_torch.models.layers import HalfSize

    rng = np.random.default_rng(10)
    x = rng.normal(size=(2, 7, 10, 3)).astype(np.float32)
    jm = JaxHalfSize(depth=3, trainable=True)
    variables = jm.init(jax.random.PRNGKey(0), x)
    port = HalfSize(3, trainable=True)
    np.testing.assert_array_equal(port.weight.detach().numpy()[:, :, 0, 0], np.eye(3))
    kernel = rng.normal(size=(1, 1, 3, 3)).astype(np.float32)
    ref = np.asarray(jm.apply({"params": {"kernel": kernel}}, x))
    holder = torch.nn.Module()
    holder.half = port
    holder.load_state_dict(from_jax_variables({"params/half/kernel": kernel}, holder))
    np.testing.assert_allclose(_nhwc(port(_nchw(x))), ref, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(np.asarray(variables["params"]["kernel"])[0, 0], np.eye(3))
