"""Connected-component labelling by flood sweeps, and the largest-component filter.

Counterpart of ``casapose_tpu/ops/connected_components.py``. Every
foreground pixel starts with its linear index + 1; sweeps of segmented
max-scans along rows and columns (both directions) flood whole runs at once
and repeat until nothing changes, at most ``max_sweeps`` times. Components
are 4-connected and carry their largest linear index + 1. Labels and masks
are integers and equal the JAX package's exactly.

The segmented max-scan is a ``cummax`` over ``segment * BIG + value``:
the segment id (a running count of background resets) is non-decreasing, so
the maximum cannot leak from one segment into the next.
"""

import torch


def _segmented_max_scan(values, resets, dim, reverse=False):
    """Max-scan of ``values`` along ``dim`` that restarts at each ``resets`` element."""
    if reverse:
        values, resets = values.flip(dim), resets.flip(dim)
    seg = torch.cumsum(resets.to(torch.int64), dim=dim)
    big = int(values.numel()) + 1
    out = torch.cummax(seg * big + values, dim=dim).values - seg * big
    return out.flip(dim) if reverse else out


def _sweep(labels, fg):
    """One row + column flood sweep, both directions."""
    resets = ~fg
    for dim in (2, 1):  # rows, then columns
        fwd = _segmented_max_scan(labels, resets, dim)
        bwd = _segmented_max_scan(labels, resets, dim, reverse=True)
        labels = torch.where(fg, torch.maximum(fwd, bwd), torch.zeros_like(labels))
    return labels


def connected_components_labels(fg, max_sweeps=64):
    """4-connected component labels of boolean masks ``fg`` [M, h, w] -> int64 [M, h, w].

    0 on background; each component carries its largest linear index + 1.
    """
    m, h, w = fg.shape
    idx = torch.arange(1, h * w + 1, dtype=torch.int64, device=fg.device).view(1, h, w)
    labels = torch.where(fg, idx, torch.zeros_like(idx))
    for _ in range(max_sweeps):
        new = _sweep(labels, fg)
        changed = bool(torch.any(new != labels))
        labels = new
        if not changed:
            break
    return labels


@torch.library.custom_op("casapose::connected_components", mutates_args=())
def _labels_op(fg: torch.Tensor, max_sweeps: int) -> torch.Tensor:
    """:func:`connected_components_labels` as one operator: its loop stops on a host read of the labels, which
    ``torch.export`` cannot trace, so an exported program calls the same loop (core/export.py)."""
    return connected_components_labels(fg, max_sweeps)


@_labels_op.register_fake
def _(fg, max_sweeps):
    return torch.empty_like(fg, dtype=torch.int64)


def largest_component_mask(fg, min_size=50, second_largest=False, weights=None, weight_bits=5):
    """Keep only the largest (or second-largest) component of each mask.

    Components smaller than ``min_size`` are dropped. ``weights`` [M, h, w]
    (integers, clipped to ``weight_bits`` bits as the JAX package's packed
    sort key clips them) count each pixel's true size. Ties go to the
    smallest label, as the JAX package's argmax over sorted labels does.
    Returns a float32 [M, h, w] mask, possibly all zero.
    """
    m, h, w = fg.shape
    labels = _labels_op(fg, 64).view(m, h * w)
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
