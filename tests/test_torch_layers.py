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
    import torch

    from casapose_tpu_torch.models.layers import BatchNorm

    with pytest.raises(NotImplementedError):
        BatchNorm(3).train()(torch.zeros(1, 3, 2, 2))


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
