"""Fused voting accumulation: kernel wrapper and plain version.

Counterpart of ``casapose_tpu/ops/voting_kernel.py::voting_accumulate_pallas``.
For every pixel and keypoint j it forms, from the raw network output
``[seg | 2k dirs | k conf]``, the unit direction n (zero where the
direction is zero), the softplus weight w and the features
w*[a, b, d, qy, qx, 1] with a = 1-ny^2, b = -ny*nx, d = 1-nx^2 and
(qy, qx) = [[a, b], [b, d]] (cy, cx), where (cy, cx) is the pixel centre
divided by the image height. The features are summed per class of the
filtered label map into S [b, oc, k, 6]; label 0 (background) is skipped.

:func:`voting_accumulate` launches the CUDA kernel ``csrc/voting.cu`` for
CUDA tensors and runs :func:`voting_accumulate_plain` for CPU tensors.
"""

import ctypes

import torch

from casapose_tpu_torch.ops import _build

# The kernel's blocks per image and group and its stages per warp, by (device, b, h, w, c, seg_dim, k): the C
# side sizes them with the occupancy API once, outside any CUDA graph capture.
_GRID = {}


def voting_accumulate_plain(output_net, labels, seg_dim, num_points):
    """Plain PyTorch version of the voting kernel.

    Args:
      output_net: [b, h, w, C] float32 raw network output.
      labels: [b, h, w] int32 filtered class labels (0 = background).
    Returns: S [b, oc, k, 6] float32.
    """
    b, h, w, _ = output_net.shape
    k = num_points
    dirs = output_net[..., seg_dim : seg_dim + 2 * k].reshape(b, h, w, k, 2)
    conf = output_net[..., seg_dim + 2 * k : seg_dim + 3 * k]
    dy, dx = dirs[..., 0], dirs[..., 1]
    norm2 = dy * dy + dx * dx
    inv = torch.rsqrt(torch.clamp(norm2, min=1e-30))
    good = norm2 > 0.0
    ny = torch.where(good, dy * inv, torch.zeros_like(dy))
    nx = torch.where(good, dx * inv, torch.zeros_like(dx))
    wgt = torch.clamp(conf, min=0.0) + torch.log1p(torch.exp(-torch.abs(conf)))
    a = (1.0 - ny * ny) * wgt
    bb = (-ny * nx) * wgt
    d = (1.0 - nx * nx) * wgt
    dtype = output_net.dtype
    cy = ((torch.arange(h, device=output_net.device, dtype=dtype) + 0.5) / h).view(1, h, 1, 1)
    cx = ((torch.arange(w, device=output_net.device, dtype=dtype) + 0.5) / h).view(1, 1, w, 1)
    qy = a * cy + bb * cx
    qx = bb * cy + d * cx
    feats = torch.stack([a, bb, d, qy, qx, wgt], dim=-1)  # [b, h, w, k, 6]
    hot = (labels.to(torch.int64)[..., None] == torch.arange(1, seg_dim, device=labels.device)).to(dtype)
    # Per-row partial sums, then a sum over rows, as the kernel sums in stages: one contraction over
    # all h*w pixels rounds ~10x worse in float32 on the card (chip_smoke.py phase 4).
    return torch.einsum("bhwo,bhwkf->bhokf", hot, feats).sum(dim=1)


def voting_accumulate(output_net, labels, seg_dim, num_points):
    """Per-class voting sums: the CUDA kernel for CUDA tensors, the plain version for CPU tensors.

    Args / returns as :func:`voting_accumulate_plain`.
    """
    if not output_net.is_cuda:
        return voting_accumulate_plain(output_net, labels, seg_dim, num_points)
    b, h, w, c = output_net.shape
    k = num_points
    oc = seg_dim - 1
    dev = output_net.device
    if output_net.dtype != torch.float32 or not output_net.is_contiguous():
        raise ValueError("voting_accumulate: output_net must be contiguous float32")
    if labels.dtype != torch.int32 or tuple(labels.shape) != (b, h, w) or not labels.is_contiguous() or labels.device != dev:
        raise ValueError(f"voting_accumulate: labels must be contiguous int32 {(b, h, w)} on {dev}")
    if c < seg_dim + 3 * k or k < 1 or oc < 1:
        raise ValueError(f"voting_accumulate: {c} channels cannot hold seg_dim={seg_dim} and {k} keypoints")
    out = torch.empty((b, oc, k, 6), dtype=torch.float32, device=dev)
    if b == 0 or h == 0 or w == 0:
        return out.zero_()
    lib = _build.load("voting")
    key = (dev.index, b, h, w, c, seg_dim, k)
    if key not in _GRID:
        stages = ctypes.c_int(0)
        with torch.cuda.device(dev):
            gx = lib.voting_grid(b, h, w, c, seg_dim, k, ctypes.byref(stages))
        if gx < 1:
            raise RuntimeError(f"voting_grid failed: CUDA error {-gx}")
        _GRID[key] = (gx, stages.value)
    gx, stages = _GRID[key]
    partials = torch.empty((b, gx, oc, k, 6), dtype=torch.float32, device=dev)
    rc = lib.voting_accumulate(
        ctypes.c_void_p(output_net.data_ptr()), ctypes.c_void_p(labels.data_ptr()),
        ctypes.c_void_p(partials.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        b, h, w, c, seg_dim, k, gx, stages, ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    )
    if rc != 0:
        raise RuntimeError(f"voting_accumulate kernel launch failed: CUDA error {rc}")
    voting_accumulate.launches += 1
    return out


voting_accumulate.launches = 0
