"""Device choice for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. There is no
silent fallback: asking for CUDA on a host without it raises.
"""

import torch


def resolve_device(device="cuda"):
    """Return ``torch.device(device)``; raise if it is CUDA and none is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "casapose_tpu_torch: CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return dev
