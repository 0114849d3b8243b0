"""Connected-component labelling by flood sweeps, and the largest-component filter.

Counterpart of ``casapose_tpu/ops/connected_components.py``. Every
foreground pixel starts with its linear index + 1; sweeps of segmented
max-scans along rows and columns (both directions) flood whole runs at once
and repeat until nothing changes, at most ``max_sweeps`` times. Components
are 4-connected and carry their largest linear index + 1. Labels (int32, as
the JAX package's) and masks equal the JAX package's exactly.

The labelling is the CC kernel's call site (``ops/cc_kernel.py``): one
launch of ``csrc/cc.cu`` for CUDA tensors, with no host read, as the JAX
package's ``lax.while_loop``; the plain loop for CPU tensors and inside
``ops/plain.py::plain_kernels("cc")``.
"""

import torch

from casapose_tpu_torch.ops.cc_kernel import (  # noqa: F401 (connected_components_plain, MAX_SWEEPS: re-exported)
    MAX_SWEEPS,
    connected_components_kernel,
    connected_components_plain,
)
from casapose_tpu_torch.ops.plain import is_plain


@torch.library.custom_op("casapose::connected_components", mutates_args=())
def _labels_op(fg: torch.Tensor, max_sweeps: int) -> torch.Tensor:
    """The CC kernel's call site as one operator, so that ``torch.export`` records it (core/export.py): the CUDA
    kernel for CUDA tensors, the plain loop for CPU tensors, through this module's
    ``connected_components_kernel``."""
    return connected_components_kernel(fg, max_sweeps)


@_labels_op.register_fake
def _(fg, max_sweeps):
    return torch.empty_like(fg, dtype=torch.int32)


def connected_components_labels(fg, max_sweeps=MAX_SWEEPS):
    """4-connected component labels of boolean masks ``fg`` [M, h, w] -> int32 [M, h, w].

    0 on background; each component carries its largest linear index + 1.
    Inside ``ops/plain.py::plain_kernels("cc")`` the plain loop on any device.
    """
    if is_plain("cc"):
        return connected_components_plain(fg, max_sweeps)
    return _labels_op(fg.contiguous(), max_sweeps)


def largest_component_mask(fg, min_size=50, second_largest=False, weights=None, weight_bits=5):
    """Keep only the largest (or second-largest) component of each mask.

    Components smaller than ``min_size`` are dropped. ``weights`` [M, h, w]
    (integers, clipped to ``weight_bits`` bits as the JAX package's packed
    sort key clips them) count each pixel's true size. Ties go to the
    smallest label, as the JAX package's argmax over sorted labels does.
    Returns a float32 [M, h, w] mask, possibly all zero.
    """
    m, h, w = fg.shape
    labels = connected_components_labels(fg).view(m, h * w).to(torch.int64)
    if weights is None:
        wflat = torch.ones_like(labels)
    else:
        wflat = torch.clamp(weights.reshape(m, h * w).to(torch.int64), max=(1 << weight_bits) - 1)
    totals = torch.zeros(m, h * w + 1, dtype=torch.int64, device=fg.device)
    totals.scatter_add_(1, labels, wflat)
    totals[:, 0] = 0  # background is no component
    score = torch.where(totals >= min_size, totals, torch.zeros_like(totals))
    best = torch.argmax(score, dim=1)
    target = torch.where(score.amax(dim=1) > 0, best, torch.full_like(best, -1))
    if second_largest:
        score2 = score.clone()
        score2.scatter_(1, best[:, None], 0)
        best2 = torch.argmax(score2, dim=1)
        target = torch.where(score2.amax(dim=1) > 0, best2, torch.full_like(best2, -1))
    keep = fg & (labels.view(m, h, w) == target.view(m, 1, 1)) & (target.view(m, 1, 1) > 0)
    return keep.to(torch.float32)
