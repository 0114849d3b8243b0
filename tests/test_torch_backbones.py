"""The port's ResNet backbones (resnet34 to resnet152) against casapose_tpu's ``ResNetBackbone`` on the CPU.

Depth and block type define a variant, so every backbone keeps its full
depth; only the images are small (64x64, batch 2: the stride-8 features are
8x8). Variables as in tests/test_torch_model.py (init plus one train-mode
pass for BatchNorm statistics), carried across by name.

Tolerances, and why. The three shallow features (x2s, x4s, x8s) agree at
rtol/atol 1e-4, as the model tests hold. The two deep ones pass through up
to 50 residual blocks, and there float32 rounding alone moves both packages
away from the exact function: against the port run in float64, the JAX
package's own float32 features are off by 2e-4 (resnet50) to 1.6e-3
(resnet152), more than 1e-4, and the port's float32 features by as much. So
for every feature the port in float64 is the reference: the JAX float32
features must lie within 5e-3 of it (a wrong layer or wiring would be off
by O(1)), and the port's float32 features no further from it than twice the
JAX package's distance plus 1e-5 (the port rounds no worse than the
reference). A bottleneck backbone also drives a whole model, whose decoders
then take 2048 channels at x32s. resnet101 and resnet152 are in
tests/test_torch_backbones_deep.py, so that no one test file holds several
of the deep compiles.
"""

import numpy as np
import pytest

from tests.torch_parity import calibrated_variables

CHANNELS = {"resnet34": (64, 64, 128, 256, 512), "resnet50": (64, 256, 512, 1024, 2048),
            "resnet101": (64, 256, 512, 1024, 2048), "resnet152": (64, 256, 512, 1024, 2048)}


def backbone_case(name, h=64, w=64, b=2):
    """The port's backbone features against the JAX backbone's and the port's own float64 run (see above)."""
    import jax
    import torch

    from casapose_tpu.core.checkpoint import unflatten_params
    from casapose_tpu.models.resnet import ResNetBackbone as JaxBackbone

    from casapose_tpu_torch.core.convert import from_jax_variables
    from casapose_tpu_torch.models.resnet import ResNetBackbone

    img = np.random.default_rng(1).normal(size=(b, h, w, 3)).astype(np.float32)
    jm = JaxBackbone(name)
    flat = calibrated_variables(jm, img)
    want = [np.asarray(f) for f in jax.jit(lambda v, x: jm.apply(v, x, train=False))(unflatten_params(flat), img)]
    model = ResNetBackbone(name).eval()
    model.load_state_dict(from_jax_variables(flat, model))
    x = torch.from_numpy(img).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = [f.numpy().transpose(0, 2, 3, 1) for f in model(x)]
        exact = [f.numpy().transpose(0, 2, 3, 1) for f in model.double()(x.double())]
    assert model.feature_channels == CHANNELS[name]
    assert [f.shape[3] for f in got] == list(CHANNELS[name])
    assert [f.shape[1] for f in got] == [h // 2, h // 4, h // 8, h // 8, h // 8]
    for i, (g, wnt, ex) in enumerate(zip(got, want, exact)):
        if i < 3:
            np.testing.assert_allclose(g, wnt, rtol=1e-4, atol=1e-4)
        jax_err, port_err = np.abs(wnt - ex).max(), np.abs(g - ex).max()
        assert jax_err <= 5e-3, (name, i, jax_err)
        assert port_err <= 2 * jax_err + 1e-5, (name, i, port_err, jax_err)


@pytest.mark.parametrize("name", ["resnet34", "resnet50"])
def test_backbone_features_match(name):
    backbone_case(name)


def test_variant_on_a_bottleneck_backbone():
    """``casapose_c_gcu4_bilat`` on resnet50: the decoders' input widths follow the backbone. Its output is held
    as the deep features are (see above): both packages' float32 outputs are ~2.5e-4 from the float64 run."""
    from tests.test_torch_variants import forward_case

    got, want, exact = forward_case("casapose_c_gcu4_bilat", base_model="resnet50", h=32, w=48, exact=True)
    jax_err, port_err = np.abs(want - exact).max(), np.abs(got - exact).max()
    assert jax_err <= 5e-3 and port_err <= 2 * jax_err + 1e-5, (jax_err, port_err)
    np.testing.assert_array_equal(got[..., :3].argmax(-1), want[..., :3].argmax(-1))


def test_unknown_backbone_raises():
    from casapose_tpu_torch.models.registry import get_model

    with pytest.raises(KeyError, match="No such backbone"):
        get_model("casapose_c_gcu5", 9, 3, base_model="resnet99", device="cpu")


@pytest.mark.parametrize("base_model", ["resnet18", "resnet34", "resnet50", "resnet101", "resnet152"])
def test_every_model_builds_on_every_backbone_in_both_dtypes(base_model):
    """Every name of the registry on ``base_model``, in float32 and bfloat16: built and run on the meta device
    (shapes and dtypes only, no arithmetic), so that every decoder width that follows the backbone is checked."""
    import torch

    from casapose_tpu_torch.models.casapose import CASAPoseModel, PVNetModel
    from casapose_tpu_torch.models.registry import MODEL_SPECS, PVNET_NAMES
    from tests.test_torch_variants import JAX_NAMES

    for name in JAX_NAMES:
        for dtype in (None, torch.bfloat16):
            with torch.device("meta"):
                if name in PVNET_NAMES:
                    model = PVNetModel(12, 3, base_model=base_model, dtype=dtype)
                else:
                    model = CASAPoseModel(MODEL_SPECS[name], 9, 3, base_model=base_model, dtype=dtype)
                out = model.eval()(torch.zeros(1, 32, 48, 3))
            assert out.shape == (1, 32, 48, 3 + model.ver_dim) and out.dtype == torch.float32, (name, dtype)
            assert model.backbone.feature_channels == CHANNELS.get(base_model, (64, 64, 128, 256, 512))
