"""Every trainable parameter of every registry model gets a gradient from one train step, under each flag that
bypasses a head or a decoder.

``build_train_step`` wraps the network in ``DistributedDataParallel``
without ``find_unused_parameters`` and without a static graph. That holds
only while every parameter that requires a gradient is reached by the
backward of every step: a parameter left without one makes DDP fail at the
next step ("Expected to have finished reduction in the prior iteration").
These tests run one ``forward_and_loss(train=True)`` and ``backward()`` on
the CPU (no process group is needed: DDP changes no graph) for each model
of the registry, and for the flags of the step that turn a head, a loss or
a decoder input off, and check ``p.grad is not None`` for each parameter.
"""

import dataclasses

import pytest
import torch

from tests.torch_parity import single_torch_thread, step_configs, synthetic_train_batch  # noqa: F401 (autouse)

OC, K, H, W = 2, 3, 32, 32
MODELS = ["casapose_c", "casapose_c_gu", "casapose_c_gcu3", "casapose_c_gcu4", "casapose_c_gcu5", "casapose_custom",
          "casapose_c_gcu5_sw5", "casapose_c_gcu4_sw1", "casapose_c_gcu5_sw1", "casapose_c_gcu4_bilat",
          "casapose_c_gcu4_sw2", "pvnet", "pvnet_combined"]
# PVNet as the harnesses run it: no confidences, no voting; per-object fields for "pvnet" (build_model_from_opt)
PVNET_CFG = dict(estimate_confidence=False, estimate_coords=False)

# (model, backbone, step config changes, loss weight changes)
CASES = [(name, "resnet18", {}, {}) for name in MODELS[:-2]] + [
    ("pvnet", "resnet18", dict(PVNET_CFG, separated_vectorfields=True), {}),
    ("pvnet_combined", "resnet18", PVNET_CFG, {}),
    ("casapose_c_gcu5", "resnet50", {}, {}),
    ("casapose_custom", "resnet18", {}, {"decoder_params": "10001,10010,00000,10000,11001"}),
    *[(name, "resnet18", cfg, {}) for name in ("casapose_c", "casapose_c_gcu5") for cfg in (
        {"train_vectors_with_ground_truth": False},  # decoder 2 on the predicted mask
        {"use_bpnp_reprojection_loss": True},
        {"estimate_coords": False},  # no voting, no keypoint loss
        {"estimate_coords": False, "estimate_confidence": False},  # no confidence channels
    )],
    ("casapose_c_gcu5", "resnet18", {}, {"vertex_loss_weight": 0.0, "proxy_loss_weight": 0.0}),
    ("casapose_c_gcu5", "resnet18", {"train_vectors_with_ground_truth": False},
     {"mask_loss_weight": 0.0, "kp_loss_weight": 0.0}),
]


@pytest.mark.parametrize("name,backbone,cfg_changes,changes", CASES,
                         ids=[f"{c[0]}-{c[1]}-{i}" for i, c in enumerate(CASES)])
def test_every_parameter_gets_a_gradient(name, backbone, cfg_changes, changes):
    from casapose_tpu_torch.losses.losses import LossWeights
    from casapose_tpu_torch.models.registry import get_model
    from casapose_tpu_torch.train import device_batch, forward_and_loss

    changes = dict(changes)
    decoder_params = changes.pop("decoder_params", None)
    _, cfg = step_configs(OC, K)
    cfg = dataclasses.replace(cfg, **cfg_changes)
    ver_dim = 2 * K * (OC if name == "pvnet" else 1) + (K if cfg.estimate_confidence else 0)
    model = get_model(name, ver_dim=ver_dim, seg_dim=OC + 1, base_model=backbone, decoder_params=decoder_params,
                      device="cpu")
    batch = device_batch(synthetic_train_batch(2, H, W, OC, K), "cpu")
    losses, _ = forward_and_loss(model, batch, cfg, LossWeights(**changes), train=True,
                                 generator=torch.Generator().manual_seed(0))
    losses[0].backward()
    assert torch.isfinite(losses[0])
    missing = [n for n, p in model.named_parameters() if p.requires_grad and p.grad is None]
    assert not missing, missing
