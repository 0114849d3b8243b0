"""Weighted least-squares keypoint voting.

Counterpart of ``casapose_tpu/ops/voting.py``. Per (object o, keypoint k)
the voted point solves the normal equations summed over the pixels p of
class o:

    R[o,k] = sum_p  w[p,k] (I - n n^T)[p,k]          (2x2)
    q[o,k] = sum_p  w[p,k] (I - n n^T)[p,k] c[p]     (2,)
    point  = pinv(R) q * h

with n the predicted unit direction, w the softplus (or sigmoid) confidence
and c the pixel centre, normalised by the image HEIGHT on both axes (the
reference's convention, kept); the result is scaled by h.

Two branches compute the sums S[b, o, k, 6] = sum w*[a, b, d, qy, qx, 1]:
  * on CUDA with ``raw_output`` (inference), the hand-written voting kernel
    (ops/voting_kernel.py) reads the raw network output and the filtered
    label map once;
  * otherwise the einsum form of the JAX package's default ``multi`` path,
    the differentiable one that the train step's keypoint loss takes.
Both normalise by the weight mass and solve the 2x2 system in closed form.

``CASAPOSE_VOTING_FORM`` selects the JAX package's layout of the XLA sums
(``casapose_tpu/ops/voting.py:220``). ``multi`` (the default), ``stack`` and
``concat`` are three XLA layouts of the same float32 sums; here all three are
the einsum form, and the voting kernel where ``raw_output`` is given on CUDA.
``bf16c`` changes the result: it centres each class on its pixel centroid,
rounds the centred features and the class mask to bfloat16 and sums them with
float32 accumulation (:func:`bf16c_points`). It is taken wherever the JAX
package's default (``CASAPOSE_VOTING=xla``) takes it, so also in place of the
voting kernel. Any other value raises.
"""

import os

import torch

from casapose_tpu_torch.core.numerics import divide_no_nan, f32_pinned
from casapose_tpu_torch.ops.connected_components import largest_component_mask
from casapose_tpu_torch.ops.plain import is_plain
from casapose_tpu_torch.ops.voting_kernel import voting_accumulate, voting_accumulate_plain


@torch.library.custom_op("casapose::voting_accumulate", mutates_args=())
def _voting_op(output_net: torch.Tensor, labels: torch.Tensor, seg_dim: int, num_points: int) -> torch.Tensor:
    """The voting kernel's call site as one operator, so that ``torch.export`` records it (core/export.py): the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors, through this module's ``voting_accumulate``."""
    return voting_accumulate(output_net, labels, seg_dim, num_points)


@_voting_op.register_fake
def _(output_net, labels, seg_dim, num_points):
    return output_net.new_empty((output_net.shape[0], seg_dim - 1, num_points, 6))


def instance_filter_mask(hot_bool, min_component_size=50, second_largest=False, downsample=4):
    """Largest-connected-component filter of per-class masks [b, h, w, oc] -> float32 keep-mask.

    Labelling runs on the 1/``downsample`` OR-pooled masks; each coarse cell
    weighs its true pixel count, so sizes are exact and only connectivity is
    coarsened.
    """
    b, h, w, oc = hot_bool.shape
    flat = hot_bool.permute(0, 3, 1, 2).reshape(b * oc, h, w)
    if downsample > 1:
        hs, ws = h // downsample, w // downsample
        cropped = flat[:, : hs * downsample, : ws * downsample]
        blocks = cropped.reshape(b * oc, hs, downsample, ws, downsample)
        small = blocks.any(dim=4).any(dim=2)
        counts = blocks.to(torch.int64).sum(dim=(2, 4))
        comp_small = largest_component_mask(
            small, min_size=min_component_size, second_largest=second_largest, weights=counts
        )
        comp = comp_small.repeat_interleave(downsample, dim=1).repeat_interleave(downsample, dim=2)
        pad_h, pad_w = h - hs * downsample, w - ws * downsample
        if pad_h or pad_w:
            comp = torch.nn.functional.pad(comp, (0, pad_w, 0, pad_h))
        comp = comp * flat.to(comp.dtype)
    else:
        comp = largest_component_mask(flat, min_size=min_component_size, second_largest=second_largest)
    return comp.reshape(b, oc, h, w).permute(0, 2, 3, 1)


def class_masks(seg, dtype, filter_estimates, min_component_size=50, second_largest=False, cc_downsample=4):
    """Hard labels [b, h, w] and per-class masks [b, h, w, oc] of ``seg``, filtered if asked."""
    oc = seg.shape[-1] - 1
    labels = torch.argmax(seg.detach(), dim=-1)
    hot = (labels[..., None] == torch.arange(1, oc + 1, device=seg.device)).to(dtype)
    if filter_estimates:
        hot = hot * instance_filter_mask(hot > 0.5, min_component_size, second_largest, downsample=cc_downsample).to(dtype)
    return labels, hot


def filtered_labels(labels, hot):
    """int32 label map in which a pixel keeps its label only where its class mask survived the filter."""
    return torch.where(hot.sum(dim=-1) > 0.5, labels, torch.zeros_like(labels)).to(torch.int32)


def _pinv_2x2_solve(a, b, d, qy, qx):
    """Solve [[a, b], [b, d]] p = [qy, qx], with the rank-1 pseudo-inverse fallback."""
    det = a * d - b * b
    trace = a + d
    scale = torch.clamp(trace, min=1e-30)
    ok = det > (1e-6 * scale * scale)
    safe_det = torch.where(ok, det, torch.ones_like(det))
    py_full = (d * qy - b * qx) / safe_det
    px_full = (-b * qy + a * qx) / safe_det
    inv_tr2 = divide_no_nan(1.0, scale * scale)
    py_r1 = (a * qy + b * qx) * inv_tr2
    px_r1 = (b * qy + d * qx) * inv_tr2
    return torch.where(ok, py_full, py_r1), torch.where(ok, px_full, px_r1)


def _solve_sums(S, h):
    """S [b, oc, k, 6] -> voted points [b, oc, k, 2] (y, x), scaled by h."""
    mass = torch.clamp(S[..., 5], min=1e-20)
    py, px = _pinv_2x2_solve(S[..., 0] / mass, S[..., 1] / mass, S[..., 2] / mass, S[..., 3] / mass, S[..., 4] / mass)
    return torch.stack([py, px], dim=-1).to(torch.promote_types(S.dtype, torch.float32)) * float(h)


VOTING_FORMS = ("multi", "stack", "concat", "bf16c")


def voting_form():
    """``CASAPOSE_VOTING_FORM`` (default ``multi``), checked against :data:`VOTING_FORMS`."""
    form = os.environ.get("CASAPOSE_VOTING_FORM", "multi")
    if form not in VOTING_FORMS:
        raise ValueError(f"CASAPOSE_VOTING_FORM={form!r}: expected one of {VOTING_FORMS}")
    return form


def _features(directions, weights, sigmoid_weights, h, w):
    """Per-pixel weights w and normal-matrix entries a, b, d [b, h, w, k], and the pixel centres cy [1, h, 1, 1],
    cx [1, 1, w, 1] over the image height."""
    b = directions.shape[0]
    k = weights.shape[-1]
    dtype, dev = directions.dtype, directions.device
    wgt = torch.sigmoid(weights) if sigmoid_weights else torch.logaddexp(weights, torch.zeros_like(weights))
    n = directions.reshape(b, h, w, k, 2)
    # sqrt(sum(n^2)) as jnp.linalg.norm computes it: the same value, and the same non-finite gradient where a
    # predicted direction is exactly zero (ROADMAP section 3).
    n = divide_no_nan(n, torch.sqrt(torch.sum(n * n, dim=-1, keepdim=True)))
    ny, nx = n[..., 0], n[..., 1]
    cy = ((torch.arange(h, dtype=dtype, device=dev) + 0.5) / h).view(1, h, 1, 1)
    cx = ((torch.arange(w, dtype=dtype, device=dev) + 0.5) / h).view(1, 1, w, 1)
    return wgt, 1.0 - ny * ny, -ny * nx, 1.0 - nx * nx, cy, cx


@f32_pinned  # the JAX contractions are HIGHEST whatever --matmul_precision says, in the gradient too
def einsum_sums(hot, directions, weights, sigmoid_weights):
    """The einsum form: six [oc, P] x [P, k] contractions sharing the class mask."""
    b, h, w, oc = hot.shape
    wgt, a, bb, d, cy, cx = _features(directions, weights, sigmoid_weights, h, w)
    qy = a * cy + bb * cx
    qx = bb * cy + d * cx
    parts = [torch.einsum("bhwo,bhwk->bok", hot, f * wgt) for f in (a, bb, d, qy, qx)]
    parts.append(torch.einsum("bhwo,bhwk->bok", hot, wgt))
    return torch.stack(parts, dim=-1)


@f32_pinned  # the bfloat16 products are exact in float32; TF32 must not round their sums
def bf16c_points(hot, directions, weights, sigmoid_weights):
    """The ``bf16c`` form (``casapose_tpu/ops/voting.py:221-264``): voted points [b, oc, k, 2] (y, x).

    Each class is centred on its pixel centroid c0 (float32), which shifts
    the normal equations exactly (p = p' + c0) and leaves the q features at
    the blob's radius instead of the image's. The six centred features times
    the weight, and the class mask, are rounded to bfloat16 and summed with
    float32 accumulation: one float32 [oc, P] x [P, 6k] product of the
    rounded operands, whose products are exact in float32 (a bfloat16
    product would round the sums; ``torch.bmm(..., out_dtype=float32)`` on
    bfloat16 operands summed 10x less accurately on an H100, 3e-4 of the
    largest sum against 3e-5, and has no derivative). The 2x2 solve is
    float32.
    """
    b, h, w, oc = hot.shape
    k = weights.shape[-1]
    wgt, a, bb, d, cy, cx = _features(directions, weights, sigmoid_weights, h, w)
    inv_m0 = divide_no_nan(torch.ones((), dtype=hot.dtype, device=hot.device), hot.sum(dim=(1, 2)))  # [b, oc]
    c0y = torch.sum(hot * cy, dim=(1, 2)) * inv_m0
    c0x = torch.sum(hot * cx, dim=(1, 2)) * inv_m0
    cyp = cy - torch.einsum("bhwo,bo->bhw", hot, c0y)[..., None]  # centred on the pixel's class centroid
    cxp = cx - torch.einsum("bhwo,bo->bhw", hot, c0x)[..., None]
    feats = torch.cat([f * wgt for f in (a, bb, d, a * cyp + bb * cxp, bb * cyp + d * cxp)] + [wgt], dim=-1)
    hot16 = hot.to(torch.bfloat16).to(torch.float32).reshape(b, h * w, oc)
    feats16 = feats.to(torch.bfloat16).to(torch.float32).reshape(b, h * w, 6 * k)
    S = torch.einsum("bpo,bpf->bof", hot16, feats16)
    points = _solve_sums(S.reshape(b, oc, 6, k).transpose(2, 3), 1.0)
    return (points + torch.stack([c0y, c0x], dim=-1)[:, :, None]) * float(h)


def ls_voting(
    seg,
    directions,
    weights,
    num_points=9,
    sigmoid_weights=False,
    filter_estimates=False,
    output_second_largest_component=False,
    min_component_size=50,
    cc_downsample=4,
    raw_output=None,
):
    """Weighted least-squares keypoint voting.

    Args:
      seg: [b, h, w, 1+oc] segmentation logits; hard-argmaxed.
      directions: [b, h, w, 2k] predicted (dy, dx) fields.
      weights: [b, h, w, k] raw confidences.
      filter_estimates: keep only the largest connected component of at
        least ``min_component_size`` px of each class mask.
      raw_output: optional [b, h, w, 1+oc+3k] raw network output
        ``[seg | dirs | conf]``. On CUDA (and without sigmoid weights) the
        sums come from the voting kernel in one pass over it; inside
        ``ops/plain.py::plain_kernels("voting")`` from its plain version,
        on any device.
    Returns:
      [b, oc, k, 2] voted keypoints, (y, x) pixels.
    """
    b, h, w, c = seg.shape
    k = num_points
    labels, hot = class_masks(
        seg, directions.dtype, filter_estimates, min_component_size, output_second_largest_component, cc_downsample
    )
    if voting_form() == "bf16c":
        return bf16c_points(hot, directions, weights, sigmoid_weights)
    plain = is_plain("voting")
    if raw_output is not None and not sigmoid_weights and (raw_output.is_cuda or plain):
        labels_f = filtered_labels(labels, hot)
        accumulate = voting_accumulate_plain if plain else _voting_op
        S = accumulate(raw_output.detach().to(torch.float32).contiguous(), labels_f, c, k)
    else:
        S = einsum_sums(hot, directions, weights, sigmoid_weights)
    return _solve_sums(S, h)
