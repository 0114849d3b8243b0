"""casapose_tpu_torch's casapose_c_gcu5 and resnet18 against casapose_tpu on the CPU.

64x64 images, batch 2, 2 objects, 3 keypoints. The JAX variables are built
once per module (init plus one train-mode pass for BatchNorm statistics,
see tests/torch_parity.py) and carried across with ``from_jax_variables``.
Tolerance: rtol 1e-4, atol 1e-4 (float32 through ~20 convolutions).
"""

import numpy as np
import pytest

from tests.torch_parity import calibrated_variables, torch_model

OC, K, H, W, B = 2, 3, 64, 64, 2
SEG_DIM, VER_DIM = 1 + OC, 3 * K


@pytest.fixture(scope="module")
def case():
    import jax

    from casapose_tpu.core.checkpoint import unflatten_params
    from casapose_tpu.models.registry import get_model as jax_get_model

    img = np.random.default_rng(0).normal(size=(B, H, W, 3)).astype(np.float32)
    jm = jax_get_model("casapose_c_gcu5", ver_dim=VER_DIM, seg_dim=SEG_DIM)
    flat = calibrated_variables(jm, img)
    variables = unflatten_params(flat)
    out = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, img))
    return img, flat, out


def test_resnet18_stride8_features_match(case):
    import jax
    import torch

    from casapose_tpu.core.checkpoint import unflatten_params
    from casapose_tpu.models.resnet import ResNetBackbone

    img, flat, _ = case
    sub = {k: v for k, v in flat.items() if k.split("/")[1] == "backbone"}
    variables = unflatten_params({k.replace("/backbone/", "/", 1): v for k, v in sub.items()})
    ref = jax.jit(lambda v, x: ResNetBackbone("resnet18").apply(v, x, train=False))(variables, img)
    model = torch_model(flat, VER_DIM, SEG_DIM)
    with torch.no_grad():
        feats = model.backbone(torch.from_numpy(img).permute(0, 3, 1, 2))
    assert [f.shape[1] for f in feats] == [64, 64, 128, 256, 512]
    assert [f.shape[2] for f in feats] == [H // 2, H // 4, H // 8, H // 8, H // 8]
    for got, want in zip(feats, ref):
        np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_casapose_c_gcu5_forward_matches(case):
    import torch

    img, flat, ref = case
    model = torch_model(flat, VER_DIM, SEG_DIM)
    with torch.no_grad():
        out = model(torch.from_numpy(img)).numpy()
    assert out.shape == (B, H, W, SEG_DIM + VER_DIM)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(out[..., :SEG_DIM].argmax(-1), ref[..., :SEG_DIM].argmax(-1))


def test_weight_bridge_maps_every_variable(case):
    from casapose_tpu_torch.core.convert import from_jax_variables
    from casapose_tpu_torch.models.registry import get_model

    _, flat, _ = case
    model = get_model("casapose_c_gcu5", ver_dim=VER_DIM, seg_dim=SEG_DIM, device="cpu")
    sd = from_jax_variables(flat, model)
    assert set(sd) == set(model.state_dict())
    w = sd["backbone.conv0.weight"].numpy()
    np.testing.assert_array_equal(w, flat["params/backbone/conv0/kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["pv_block_6_clade.bn.running_var"].numpy(), flat["batch_stats/pv_block_6_clade/bn/var"])


@pytest.mark.parametrize("defect", ["missing", "unused", "unknown_leaf", "shape"])
def test_weight_bridge_raises(case, defect):
    from casapose_tpu_torch.core.convert import from_jax_variables
    from casapose_tpu_torch.models.registry import get_model

    _, flat, _ = case
    flat = dict(flat)
    if defect == "missing":
        del flat["params/pv_final_conv_vertex/kernel"]
    elif defect == "unused":
        flat["params/extra_layer/kernel"] = np.zeros((1, 1, 2, 2), np.float32)
    elif defect == "unknown_leaf":
        flat["params/pv_block_1_bn/offset"] = np.zeros(2, np.float32)
    else:
        flat["params/pv_block_1_bn/scale"] = np.zeros(3, np.float32)
    model = get_model("casapose_c_gcu5", ver_dim=VER_DIM, seg_dim=SEG_DIM, device="cpu")
    with pytest.raises(ValueError if defect == "shape" else KeyError):
        from_jax_variables(flat, model)


@pytest.mark.parametrize("name,base", [("casapose_x", "resnet18"), ("pvnet_x", "resnet18"), ("casapose_c_gcu5", "resnet99")])
def test_registry_refuses_what_is_not_ported(name, base):
    """Every name and backbone of the JAX registry is ported (tests/test_torch_variants.py); others raise as there."""
    from casapose_tpu_torch.models.registry import get_model

    with pytest.raises(KeyError if base == "resnet99" else ValueError):
        get_model(name, ver_dim=VER_DIM, seg_dim=SEG_DIM, base_model=base, device="cpu")


def test_random_weights_follow_the_generator():
    import torch

    from casapose_tpu_torch.models.registry import get_model

    def weights(seed):
        m = get_model("casapose_c_gcu5", VER_DIM, SEG_DIM, device="cpu", generator=torch.Generator().manual_seed(seed))
        return m.pv_block_1_conv2d.weight

    assert torch.equal(weights(3), weights(3))
    assert not torch.equal(weights(3), weights(4))
    bound = (6.0 / (512 * 9)) ** 0.5  # he_uniform, as the JAX package initialises convs
    assert weights(3).abs().max().item() <= bound
