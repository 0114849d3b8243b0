"""Every model of the JAX registry, built by the port, against casapose_tpu on the CPU.

Each name of ``MODEL_SPECS`` and ``PVNET_NAMES``, and ``casapose_custom``
from a decoder string, on resnet18: 64x64 images, batch 2, 2 objects, 3
keypoints. The JAX variables are built per model (init plus one train-mode
pass for BatchNorm statistics, see tests/torch_parity.py) and carried
across with ``from_jax_variables(flat, model)``, whose strict check (no
missing or unused key, equal shapes) is part of the test.
Tolerance: rtol 1e-4, atol 1e-4 (float32 through ~20 convolutions, as
tests/test_torch_model.py holds the flagship); the predicted labels are
equal.
"""

import numpy as np
import pytest

from tests.torch_parity import calibrated_variables

OC, K, H, W, B = 2, 3, 64, 64, 2
SEG_DIM = 1 + OC
# wc pc gu bu rc per layer: layer 1 shared (its decoder-1 output reused), layer 2 bilinear without a guide,
# layer 3 BatchNorm without CLADE (bilinear resize), layer 4 nearest, layer 5 shared without the mask.
CUSTOM = "10001,10010,00000,10000,11001"

JAX_NAMES = (
    "casapose_c", "casapose_c_gu", "casapose_c_gcu3", "casapose_c_gcu4", "casapose_c_gcu5", "casapose_custom",
    "casapose_c_gcu5_sw5", "casapose_c_gcu4_sw1", "casapose_c_gcu5_sw1", "casapose_c_gcu4_bilat",
    "casapose_c_gcu4_sw2", "pvnet", "pvnet_combined",
)


def ver_dim(name):
    return 2 * K * OC if name.startswith("pvnet") else 3 * K


def forward_case(name, decoder_params=None, base_model="resnet18", h=H, w=W, b=B, output_labelmap=False,
                 exact=False):
    """(port output, JAX output) of one model on a seeded image, weights carried across from JAX; with
    ``exact``, also the port's output run in float64."""
    import jax
    import torch

    from casapose_tpu.core.checkpoint import unflatten_params
    from casapose_tpu.models.registry import get_model as jax_get_model

    from casapose_tpu_torch.core.convert import from_jax_variables
    from casapose_tpu_torch.models.registry import get_model

    img = np.random.default_rng(0).normal(size=(b, h, w, 3)).astype(np.float32)
    kw = {"decoder_params": decoder_params} if decoder_params else {}
    jm = jax_get_model(name, ver_dim=ver_dim(name), seg_dim=SEG_DIM, base_model=base_model,
                       output_labelmap=output_labelmap, **kw)
    flat = calibrated_variables(jm, img)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(unflatten_params(flat), img))
    model = get_model(name, ver_dim(name), SEG_DIM, base_model=base_model, output_labelmap=output_labelmap,
                      device="cpu", **kw)
    model.load_state_dict(from_jax_variables(flat, model))
    with torch.no_grad():
        got = model(torch.from_numpy(img)).numpy()
        if exact:
            return got, want, model.double()(torch.from_numpy(img).double()).numpy()
    return got, want


def test_the_port_has_every_name_of_the_jax_registry():
    from casapose_tpu.models import registry as jr

    from casapose_tpu_torch.models import registry as tr

    assert set(JAX_NAMES) == set(jr.MODEL_SPECS) | set(jr.PVNET_NAMES)
    assert tr.Classifiers.models_names() == jr.Classifiers.models_names()
    assert tr.MODEL_SPECS.keys() == jr.MODEL_SPECS.keys()
    for name, spec in jr.MODEL_SPECS.items():  # the same wiring, field by field
        assert str(tr.MODEL_SPECS[name]) == str(spec), name
    for text in (CUSTOM, "11000,11100,11100,11100,11000"):
        assert [str(p) for p in tr.parse_decoder_params(text)] == [str(p) for p in jr.parse_decoder_params(text)]


@pytest.mark.parametrize("name", JAX_NAMES)
def test_variant_forward_matches(name):
    got, want = forward_case(name)
    assert got.shape == (B, H, W, SEG_DIM + ver_dim(name))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got[..., :SEG_DIM].argmax(-1), want[..., :SEG_DIM].argmax(-1))


@pytest.mark.parametrize("name", ["casapose_custom", "pvnet"])
def test_output_labelmap_and_custom_decoder_string(name):
    """``output_labelmap`` (label | vertex), with ``casapose_custom`` built from a decoder string."""
    got, want = forward_case(name, decoder_params=CUSTOM if name == "casapose_custom" else None, output_labelmap=True)
    assert got.shape == (B, H, W, 1 + ver_dim(name))
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("call, error", [
    (dict(name="casapose_x"), "No such model `casapose_x`"),
    (dict(name="casapose_c_gcu5", decoder_params="11000,11100,11100,11100,11000"), "only configurable"),
    (dict(name="casapose_custom", decoder_params="1100,11100"), "5 comma-separated 5-bit groups"),
    (dict(name="casapose_c_gcu5", dtype="float16"), "float32 or bfloat16"),
])
def test_registry_errors(call, error):
    from casapose_tpu_torch.models.registry import get_model

    with pytest.raises(ValueError, match=error):
        get_model(ver_dim=9, seg_dim=3, device="cpu", **call)


def test_build_model_from_opt_sizes_the_output():
    """PVNet's ver_dim is per object, confidence adds k, ``custom_decoder_params`` and ``compute_dtype`` pass on
    (casapose_tpu/train.py::build_model_from_opt)."""
    import torch

    from casapose_tpu.train import build_model_from_opt as jax_build
    from casapose_tpu.utils.config import parse_config as jax_parse

    from casapose_tpu_torch.models.registry import build_model_from_opt
    from casapose_tpu_torch.utils.config import parse_config

    cases = [
        ["--modelname", "pvnet", "--estimate_confidence", "0", "--no_points", "9"],
        ["--modelname", "pvnet", "--estimate_confidence", "1", "--no_points", "9"],
        ["--modelname", "casapose_c_gcu5", "--estimate_confidence", "1", "--no_points", "9"],
        ["--modelname", "casapose_custom", "--estimate_confidence", "0", "--custom_decoder_params", CUSTOM],
        ["--modelname", "casapose_c_gu", "--estimate_confidence", "1", "--compute_dtype", "bfloat16"],
    ]
    for flags in cases:
        flags = flags + ["--object", "obj_000001,obj_000002,obj_000003"]
        jm = jax_build(jax_parse(flags), 3)
        model = build_model_from_opt(parse_config(flags), 3, device="cpu")
        assert (model.ver_dim, model.seg_dim) == (jm.ver_dim, jm.seg_dim), flags
        assert model.dtype == (torch.bfloat16 if jm.dtype is not None else None), flags
        if "--custom_decoder_params" in flags:
            assert str(model.spec) == str(jm.spec)
    with pytest.raises(ValueError, match="only configurable"):
        build_model_from_opt(parse_config(["--modelname", "casapose_c_gu", "--custom_decoder_params", CUSTOM]), 3,
                             device="cpu")


@pytest.mark.parametrize("modelname, base_model, dtype", [
    ("casapose_c_gcu4_bilat", "resnet50", "float32"), ("casapose_c_gcu5", "resnet18", "bfloat16"),
    ("pvnet", "resnet18", "float32"),
])
def test_inference_entry_point_builds_every_kind(modelname, base_model, dtype):
    """``build_inference_step`` with another variant and backbone, in bfloat16, and for PVNet (RANSAC voting over
    the per-object fields, as the eval step's RANSAC branch votes)."""
    import torch

    from casapose_tpu_torch.entry import build_inference_step
    from casapose_tpu_torch.pose.evaluation import estimate_and_evaluate_poses

    b, h, w, oc, k = 1, 32, 40, 2, 3
    step, model = build_inference_step(oc, k, h, w, device="cpu", modelname=modelname, base_model=base_model,
                                       dtype=getattr(torch, dtype), ransac_rounds=2)
    assert model.dtype == (torch.bfloat16 if dtype == "bfloat16" else None)
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.normal(size=(b, h, w, 3)).astype(np.float32))
    kp3 = torch.from_numpy(rng.uniform(-0.05, 0.05, (b, oc, 1, k, 3)).astype(np.float32))
    cam = torch.tensor([[[100.0, 0.0, w / 2], [0.0, 100.0, h / 2], [0.0, 0.0, 1.0]]])
    poses, coords = step(img, kp3, cam, return_points=True)
    assert poses.shape == (b, oc, 1, 3, 4) and coords.shape == (b, oc, k, 2)
    assert torch.isfinite(poses).all() and torch.isfinite(coords).all()
    if modelname == "pvnet":
        with torch.no_grad():
            out = model(img)
        seg = out[..., : 1 + oc]
        target = torch.nn.functional.one_hot(seg.argmax(-1), 1 + oc).float()
        offsets = torch.tensor([[0, 0, h, w, 0, 0, 0, 1.0, w, h]])
        _, _, points = estimate_and_evaluate_poses(
            seg, target, out[..., 1 + oc :], torch.zeros(b, oc, 1, 3, 4), kp3, cam, torch.ones(b, oc, 1, 1), offsets,
            min_num=20, ransac_rounds=2)
        torch.testing.assert_close(coords, points.flip(-1), rtol=0, atol=0)
