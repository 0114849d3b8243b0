"""Model registry: reference model names -> PyTorch modules.

Counterpart of ``casapose_tpu/models/registry.py::get_model``. Only the
flagship ``casapose_c_gcu5`` on resnet18 is ported; every other name of the
JAX package's ``MODEL_SPECS`` raises ``NotImplementedError`` (ROADMAP.md
lists them).
"""

import torch

from casapose_tpu_torch.core.device import resolve_device
from casapose_tpu_torch.models.casapose import CASAPoseGCU5, init_weights

PORTED_MODELS = ("casapose_c_gcu5",)


def get_model(name, ver_dim, seg_dim, base_model="resnet18", device="cuda", generator=None):
    """Build a model in eval mode on ``device``, weights drawn from ``generator``.

    The weights are drawn on the CPU, so one seed gives the same model on any
    device. ``generator`` defaults to ``torch.Generator().manual_seed(0)``.
    """
    dev = resolve_device(device)
    if name not in PORTED_MODELS:
        raise NotImplementedError(f"model `{name}` is not ported yet; ported: {PORTED_MODELS}")
    if base_model != "resnet18":
        raise NotImplementedError(f"backbone `{base_model}` is not ported yet; ported: resnet18")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = init_weights(CASAPoseGCU5(ver_dim=ver_dim, seg_dim=seg_dim), generator)
    return model.eval().to(dev)
