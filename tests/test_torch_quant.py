"""The port's int8 inference (``casapose_tpu_torch/ops/quant.py``) against the JAX package's ``ops/quant.py``.

Inputs and weights are made with numpy from a seed and handed to both
packages. Tolerances, and why:

  * one layer (the four geometries of tests/test_quant.py, the partial conv
    masked and unmasked) on the same float32 input and weights: the int8
    codes come from one float32 division and a round-half-even in each
    package, so they are equal but for ties that land on the other side of a
    rounding; at most 1e-3 of the codes may differ, by one code and no more
    (0 differ in these cases). The int32 sums from the same codes are exact:
    equal bit for bit. The outputs, one float32 rescale of equal sums: rtol
    1e-6, atol 1e-6 of the output's max (equal in these cases);
  * the whole ``casapose_c_gcu5`` forward (64x64, 2 objects, 9 keypoints,
    calibrated weights) layer by layer: each int8 layer fed the input the
    JAX package's jitted int8 forward gave it (see the test for the bands).
    The two forwards are not compared end to end: the int8 forward is
    discontinuous at every rounding tie, and one code that XLA's jitted
    program rounds the other way in a stage-4 convolution reaches the heads
    and, through the segmentation's hard argmax, decoder 2. The JAX
    package's own jitted int8 forward gives image 1 of a batch other outputs
    than image 1 alone for the same reason, which its tests/test_quant.py,
    run eagerly, does not see;
  * int8 against the port's own float32 forward: tests/test_quant.py's
    fidelity bands;
  * a batch against its images one by one: bit for bit (per-image scales).
"""

import contextlib

import numpy as np
import pytest

from tests.torch_parity import calibrated_variables, single_torch_thread, torch_model  # noqa: F401 (autouse)

OC, K, H, W = 2, 9, 64, 64
SEG_DIM = 1 + OC


@contextlib.contextmanager
def _jax_int8_products():
    """Record the int8 products the JAX quantized layers run: (operation, int8 lhs, int8 rhs, int32 result)."""
    import jax

    rec = []
    conv0, dot0 = jax.lax.conv_general_dilated, jax.lax.dot_general

    def conv(lhs, rhs, *a, **k):
        out = conv0(lhs, rhs, *a, **k)
        if lhs.dtype == np.int8:
            rec.append(("conv", np.asarray(lhs), np.asarray(rhs), np.asarray(out)))
        return out

    def dot(lhs, rhs, *a, **k):
        out = dot0(lhs, rhs, *a, **k)
        if lhs.dtype == np.int8:
            rec.append(("dot", np.asarray(lhs), np.asarray(rhs), np.asarray(out)))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.lax, "conv_general_dilated", conv)
        mp.setattr(jax.lax, "dot_general", dot)
        yield rec


def _codes_agree(got, want):
    """At most 1e-3 of the codes differ, each by one code at most; returns the share that differs."""
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1, f"codes differ by {d.max()}"
    assert (d > 0).mean() <= 1e-3, f"{(d > 0).mean():.2e} of the codes differ"
    return (d > 0).mean()


def _close_to_f32_rounding(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


# Explicit symmetric padding, as every convolution of the model has it (the stem's 7x7 / 2 pads 3 on each side,
# where tests/test_quant.py's "SAME" would pad 2 and 3).
GEOMETRIES = [(3, 1, 1, 1), (1, 1, 0, 1), (7, 2, 3, 1), (3, 1, 2, 2)]


@pytest.mark.parametrize("kernel,stride,pad,dilation", GEOMETRIES,
                         ids=["3x3", "1x1", "7x7_stride2", "3x3_dilation2"])
def test_quantized_conv_matches_jax(kernel, stride, pad, dilation):
    import flax.linen as nn
    import jax
    import jax.numpy as jnp
    import torch

    from casapose_tpu.ops.quant import quantized_convs as jax_quantized_convs
    from casapose_tpu_torch.models.layers import Conv
    from casapose_tpu_torch.ops import quant

    rng = np.random.default_rng(kernel * 10 + dilation)
    x = rng.normal(size=(2, 16, 20, 8)).astype(np.float32)
    x[1] *= 7.0  # another scale per image
    conv = nn.Conv(12, (kernel, kernel), strides=(stride, stride), padding=[(pad, pad)] * 2,
                   kernel_dilation=(dilation, dilation), use_bias=False)
    variables = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    with _jax_int8_products() as rec, jax_quantized_convs():
        want = np.asarray(conv.apply(variables, jnp.asarray(x)))
    (_, xq_j, wq_j, acc_j), = rec

    mod = Conv(8, 12, kernel, stride, pad, dilation)
    mod.weight.data = torch.from_numpy(np.asarray(variables["params"]["kernel"]).transpose(3, 2, 0, 1).copy())
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    xq, _ = quant.activation_codes(xt)
    wq, _ = quant.weight_codes(mod.weight)
    _codes_agree(xq.permute(0, 2, 3, 1).numpy(), xq_j)
    _codes_agree(wq.permute(2, 3, 1, 0).numpy(), wq_j)
    acc = quant.conv_accumulators(torch.from_numpy(xq_j).permute(0, 3, 1, 2), torch.from_numpy(wq_j).permute(3, 2, 0, 1),
                                  mod.stride, mod.padding, mod.dilation)
    np.testing.assert_array_equal(acc.numpy(), acc_j)
    with torch.no_grad(), quant.quantized_convs():
        got = mod(xt).permute(0, 2, 3, 1).numpy()
    _close_to_f32_rounding(got, want)


@pytest.mark.parametrize("masked", [False, True])
def test_quantized_partial_conv_matches_jax(masked):
    import jax
    import jax.numpy as jnp
    import torch

    from casapose_tpu.models.layers import PartialConv as JaxPartialConv
    from casapose_tpu.ops.quant import quantized_convs as jax_quantized_convs
    from casapose_tpu_torch.models.layers import PartialConv
    from casapose_tpu_torch.ops import quant

    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 12, 14, 8)).astype(np.float32)
    labels = rng.integers(0, 3, (2, 12, 14))
    seg = np.eye(3, dtype=np.float32)[labels] if masked else None
    pc = JaxPartialConv(10, 3)
    jseg = None if seg is None else jnp.asarray(seg)
    variables = pc.init(jax.random.PRNGKey(0), jnp.asarray(x), jseg)
    with _jax_int8_products() as rec, jax_quantized_convs():
        want = np.asarray(pc.apply(variables, jnp.asarray(x), jseg))

    mod = PartialConv(8, 10)
    mod.weight.data = torch.from_numpy(np.asarray(variables["params"]["kernel"]).transpose(3, 2, 0, 1).copy())
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    xq, _ = quant.activation_codes(xt)
    wq, _ = quant.weight_codes(mod.weight)
    if masked:  # nine masked taps; the centre tap's mask is all ones, so its lhs is the JAX codes themselves
        assert [r[0] for r in rec] == ["dot"] * 9
        xq_j, acc_j = rec[4][1], sum(r[3].astype(np.int64) for r in rec)
        wq_j = np.stack([r[2] for r in rec]).reshape(3, 3, 8, 10)
        acc, _ = quant.partial_conv_accumulators(torch.from_numpy(xq_j).permute(0, 3, 1, 2),
                                                 torch.from_numpy(wq_j).permute(3, 2, 0, 1),
                                                 torch.from_numpy(labels)[:, None])
    else:
        (_, xq_j, wq_j, acc_j), = rec
        acc = quant.conv_accumulators(torch.from_numpy(xq_j).permute(0, 3, 1, 2),
                                      torch.from_numpy(wq_j).permute(3, 2, 0, 1), (1, 1), (1, 1), (1, 1))
    _codes_agree(xq.permute(0, 2, 3, 1).numpy(), xq_j)
    _codes_agree(wq.permute(2, 3, 1, 0).numpy(), wq_j)
    np.testing.assert_array_equal(acc.numpy(), acc_j)
    seg_t = None if seg is None else torch.from_numpy(seg).permute(0, 3, 1, 2)
    with torch.no_grad(), quant.quantized_convs():
        got = mod(xt, seg_t).permute(0, 2, 3, 1).numpy()
    _close_to_f32_rounding(got, want)


@pytest.mark.parametrize("m,k,n", [(5, 147, 9), (40, 27, 64), (17, 8, 8)])
def test_int8_matmul_pads_to_the_int_mm_rules(m, k, n):
    """Rows, taps and output channels that the card's ``_int_mm`` refuses (at most 16 rows, widths not multiples of
    8) are padded with zero codes and sliced: the sums equal the exact integer product."""
    import torch

    from casapose_tpu_torch.ops.quant import int8_matmul

    rng = np.random.default_rng(m)
    a = rng.integers(-127, 128, (m, k)).astype(np.int8)
    b = rng.integers(-127, 128, (n, k)).astype(np.int8)
    got = int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32 and tuple(got.shape) == (m, n)
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ b.astype(np.int64).T)


@pytest.fixture(scope="module")
def forward_case():
    """Calibrated weights for both packages, and every quantized layer of the JAX package's int8 forward (jitted,
    as its eval step runs it) with its input, its mask and its output: {module path: [(x, seg, out), ...]}."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    from casapose_tpu.core.checkpoint import unflatten_params
    from casapose_tpu.models.layers import PartialConv as JaxPartialConv
    from casapose_tpu.models.registry import get_model as jax_get_model
    from casapose_tpu.ops import quant as jax_quant

    rng = np.random.default_rng(1)
    img = rng.uniform(-1, 1, (2, H, W, 3)).astype(np.float32)
    img[0, 3, 4, :] = 50.0  # an outlier in image 0: its scales must not coarsen image 1's
    jm = jax_get_model("casapose_c_gcu5", ver_dim=3 * K, seg_dim=SEG_DIM, base_model="resnet18")
    flat = calibrated_variables(jm, img)

    def record(next_fun, args, kwargs, context):
        mod = context.module
        if context.method_name != "__call__" or not isinstance(mod, (nn.Conv, JaxPartialConv)):
            return next_fun(*args, **kwargs)
        out = jax_quant._interceptor(next_fun, args, kwargs, context)  # the JAX package's int8 layer
        mod.sow("intermediates", "int8_layer", (args[0], args[1] if len(args) > 1 else kwargs.get("seg_onehot"), out))
        return out

    def forward(variables, x):
        with nn.intercept_methods(record):
            return jm.apply(variables, x, train=False, mutable=["intermediates"])

    _, inter = jax.jit(forward)(unflatten_params(flat), jnp.asarray(img))
    layers = {}
    for path, calls in jax.tree_util.tree_flatten_with_path(
            inter["intermediates"], is_leaf=lambda v: isinstance(v, tuple) and len(v) == 3)[0]:
        name = ".".join(p.key for p in path if hasattr(p, "key"))
        layers.setdefault(name.rsplit(".int8_layer", 1)[0], []).append(
            tuple(None if v is None else np.asarray(v) for v in calls))
    return img, flat, layers, torch_model(flat, 3 * K, SEG_DIM)


def test_quantized_forward_matches_jax_layer_by_layer(forward_case):
    """Every int8 layer of the flagship forward (the backbone's convs, both decoders' convs and partial convs, the
    heads) fed the input that the JAX package's own int8 forward gave it: the port's output equals JAX's to float32
    rounding (1e-6 of the output's max) on all but 2e-3 of the elements, and those lie within 1e-3 of the max (a few
    codes' worth: ties that round the other way; measured at most 6.9e-4 of the elements of the two stage-4
    convolutions, 2.9e-4 of the max, every other layer within rounding). End to end the two forwards are not held
    elementwise: the forward is discontinuous at every rounding tie, and decoder 1 carries one flipped code of the
    stage-4 convolutions to the heads (the segmentation's hard argmax then moves decoder 2)."""
    import torch

    from casapose_tpu_torch.ops.quant import quantized_convs

    _, _, layers, model = forward_case
    assert len(layers) >= 30, sorted(layers)  # 19 backbone convs, decoders 1 and 2, the two heads
    exact = 0
    for name, calls in layers.items():
        mod = model.get_submodule(name)
        for x, seg, want in calls:
            xt = torch.from_numpy(x.copy()).permute(0, 3, 1, 2)
            args = (xt,) if seg is None else (xt, torch.from_numpy(seg.copy()).permute(0, 3, 1, 2))
            with torch.no_grad(), quantized_convs():
                got = mod(*args).permute(0, 2, 3, 1).numpy()
            rel = np.abs(got - want) / max(np.abs(want).max(), 1e-30)
            assert (rel > 1e-6).mean() <= 2e-3 and rel.max() <= 1e-3, (name, (rel > 1e-6).mean(), rel.max())
            exact += int(rel.max() <= 1e-6)
    assert exact >= len(layers) - 4, exact


def _relative_to_head(got, want):
    """|got - want| over each head's max |want|: the segmentation's, then the vertex head's."""
    return [(np.abs(got[..., sl] - want[..., sl]) / max(np.abs(want[..., sl]).max(), 1e-6))
            for sl in (slice(0, SEG_DIM), slice(SEG_DIM, None))]


def test_quantized_forward_fidelity(forward_case):
    """int8 against the port's own float32 forward in tests/test_quant.py's setting (the JAX init of PRNGKey(2), one
    uniform image of seed 1) and within its bands: p99 0.05 and median 0.02 of each head's max, segmentation worst
    case 0.15, argmax agreement 0.97."""
    import jax
    import jax.numpy as jnp
    import torch

    from casapose_tpu.core.checkpoint import flatten_params
    from casapose_tpu.models.registry import get_model as jax_get_model
    from casapose_tpu_torch.ops.quant import quantized_apply

    img = np.random.default_rng(1).uniform(-1, 1, (1, H, W, 3)).astype(np.float32)
    jm = jax_get_model("casapose_c_gcu5", ver_dim=3 * K, seg_dim=SEG_DIM, base_model="resnet18")
    variables = jax.jit(lambda r, x: jm.init(r, x, train=False))(jax.random.PRNGKey(2), jnp.asarray(img))
    model = torch_model(flatten_params(variables), 3 * K, SEG_DIM)
    x = torch.from_numpy(img)
    out = quantized_apply(model, x).numpy()
    with torch.no_grad():
        ref = model(x).numpy()
    seg_rel, vertex_rel = _relative_to_head(out, ref)
    for rel in (seg_rel, vertex_rel):
        assert np.quantile(rel, 0.99) < 0.05 and np.quantile(rel, 0.5) < 0.02, np.quantile(rel, [0.5, 0.99])
    assert seg_rel.max() < 0.15
    assert np.mean(out[..., :SEG_DIM].argmax(-1) == ref[..., :SEG_DIM].argmax(-1)) > 0.97


def test_quantized_batch_independence(forward_case):
    """The batch, whose image 0 holds a 50x outlier, equal bit for bit to its images run one at a time."""
    import torch

    from casapose_tpu_torch.ops.quant import quantized_apply

    img, _, _, model = forward_case
    x = torch.from_numpy(img)
    singles = np.concatenate([quantized_apply(model, x[i : i + 1]).numpy() for i in range(2)])
    np.testing.assert_array_equal(quantized_apply(model, x).numpy(), singles)


def test_inference_step_int8_matches_its_parts_and_jax_voting(forward_case):
    """``build_inference_step(quantized="int8")``: its voted points are ``ls_voting`` of the int8 network output
    (bit for bit) and agree with the JAX ``ls_voting`` on that output (rtol 1e-4, atol 5e-3 px, the voting
    tolerance of tests/test_voting_kernel.py); its poses are ``poses_pnp`` of those points. With the bfloat16 network
    the int8 layers return bfloat16, as the JAX layer's ``out.astype(x.dtype)``."""
    import jax.numpy as jnp
    import torch

    from casapose_tpu.ops.voting import ls_voting as jax_ls_voting
    from casapose_tpu_torch.core.convert import from_jax_variables
    from casapose_tpu_torch.entry import build_inference_step
    from casapose_tpu_torch.ops.quant import quantized_apply, quantized_convs
    from casapose_tpu_torch.ops.voting import ls_voting
    from casapose_tpu_torch.pose.evaluation import poses_pnp
    from tests.torch_parity import CAMERA

    img, flat, _, _ = forward_case
    step, model = build_inference_step(no_objects=OC, k=K, h=H, w=W, device="cpu", quantized="int8")
    model.load_state_dict(from_jax_variables(flat, model))
    x = torch.from_numpy(img)
    kp3 = torch.from_numpy(np.random.default_rng(4).uniform(-0.05, 0.05, (2, OC, 1, K, 3)).astype(np.float32))
    cam = torch.from_numpy(np.broadcast_to(CAMERA, (2, 3, 3)).copy())
    poses, coords = step(x, kp3, cam, return_points=True)
    out = quantized_apply(model, x)
    seg, dirs, conf = out[..., :SEG_DIM], out[..., SEG_DIM : SEG_DIM + 2 * K], out[..., SEG_DIM + 2 * K :]
    with torch.no_grad():
        want = ls_voting(seg, dirs, conf, num_points=K, filter_estimates=True, raw_output=out)
        assert torch.equal(coords, want)
        assert torch.equal(poses, poses_pnp(coords, seg, kp3, cam, OC))
    jax_coords = jax_ls_voting(*(jnp.asarray(a.numpy()) for a in (seg, dirs, conf)), num_points=K,
                               filter_estimates=True, raw_output=jnp.asarray(out.numpy()))
    np.testing.assert_allclose(coords.numpy(), np.asarray(jax_coords), rtol=1e-4, atol=5e-3)
    with pytest.raises(ValueError):
        build_inference_step(no_objects=OC, k=K, h=H, w=W, device="cpu", quantized="int4")

    bf16, _ = build_inference_step(no_objects=OC, k=K, h=H, w=W, device="cpu", quantized="int8", dtype=torch.bfloat16)
    assert torch.isfinite(bf16(x, kp3, cam)).all()
    conv = model.backbone.stage1_unit1_conv1
    with torch.no_grad(), quantized_convs():
        y = conv(torch.randn(1, 64, 8, 8, dtype=torch.bfloat16))
    assert y.dtype == torch.bfloat16
