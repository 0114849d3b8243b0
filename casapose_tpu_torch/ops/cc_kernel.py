"""CC labelling: the kernel wrapper and its plain version.

Counterpart of ``casapose_tpu/ops/connected_components.py::connected_components_labels``,
which the JAX package runs in XLA as a ``lax.while_loop`` of flood sweeps (no
Pallas kernel). :func:`connected_components_kernel` runs the whole loop in one
launch of the CUDA kernel ``csrc/cc.cu`` for CUDA tensors, with no host read,
and :func:`connected_components_plain` for CPU tensors: the loop in PyTorch,
which reads a "changed" flag on the host after every sweep. The segmented
max-scan there is a ``cummax`` over ``segment * BIG + value``: the segment id
(a running count of background resets) is non-decreasing, so the maximum
cannot leak from one segment into the next.
"""

import ctypes

import torch

from casapose_tpu_torch.ops import _build

MAX_SWEEPS = 64  # the JAX package's cap; at the cap both packages stop with labels that are not final


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


def connected_components_plain(fg, max_sweeps=MAX_SWEEPS, return_sweeps=False):
    """Plain PyTorch version of the CC kernel: boolean masks ``fg`` [M, h, w] -> int32 labels [M, h, w].

    0 on background; each component carries its largest linear index + 1.
    Sweeps all masks together until none changes; with ``return_sweeps``
    also returns how many sweeps ran (the last changed nothing, unless the
    cap was reached), a Python int.
    """
    m, h, w = fg.shape
    idx = torch.arange(1, h * w + 1, dtype=torch.int64, device=fg.device).view(1, h, w)
    labels = torch.where(fg, idx, torch.zeros_like(idx))
    sweeps = 0
    while sweeps < max_sweeps:
        new = _sweep(labels, fg)
        changed = bool(torch.any(new != labels))
        labels = new
        sweeps += 1
        if not changed:
            break
    labels = labels.to(torch.int32)
    return (labels, sweeps) if return_sweeps else labels


def connected_components_kernel(fg, max_sweeps=MAX_SWEEPS, return_sweeps=False):
    """CC labels: the CUDA kernel for CUDA tensors, the plain version for CPU tensors.

    Args / returns as :func:`connected_components_plain`, but the kernel's
    ``return_sweeps`` gives an int32 tensor [M] on the card: the sweeps each
    mask ran (their maximum is the plain loop's count).
    """
    if not fg.is_cuda:
        return connected_components_plain(fg, max_sweeps, return_sweeps)
    if fg.dim() != 3 or fg.dtype != torch.bool or not fg.is_contiguous():
        raise ValueError(f"connected_components_kernel: fg must be a contiguous bool [M, h, w], got {fg.dtype} "
                         f"{tuple(fg.shape)}")
    m, h, w = fg.shape
    labels = torch.empty((m, h, w), dtype=torch.int32, device=fg.device)
    sweeps = torch.zeros((m,), dtype=torch.int32, device=fg.device)
    if labels.numel():
        lib = _build.load("cc")
        rc = lib.cc_label(ctypes.c_void_p(fg.data_ptr()), ctypes.c_void_p(labels.data_ptr()),
                          ctypes.c_void_p(sweeps.data_ptr()), m, h, w, int(max_sweeps),
                          ctypes.c_void_p(torch.cuda.current_stream(fg.device).cuda_stream))
        if rc != 0:
            raise RuntimeError(f"cc_label kernel launch failed: CUDA error {rc}")
        connected_components_kernel.launches += 1
    return (labels, sweeps) if return_sweeps else labels


connected_components_kernel.launches = 0
