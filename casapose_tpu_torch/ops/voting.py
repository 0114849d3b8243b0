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
"""

import torch

from casapose_tpu_torch.core.numerics import divide_no_nan, f32_pinned
from casapose_tpu_torch.ops.connected_components import largest_component_mask
from casapose_tpu_torch.ops.plain import is_plain
from casapose_tpu_torch.ops.voting_kernel import voting_accumulate, voting_accumulate_plain


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


@f32_pinned  # the JAX contractions are HIGHEST whatever --matmul_precision says, in the gradient too
def einsum_sums(hot, directions, weights, sigmoid_weights):
    """The einsum form: six [oc, P] x [P, k] contractions sharing the class mask."""
    b, h, w, oc = hot.shape
    k = weights.shape[-1]
    dtype = directions.dtype
    wgt = torch.sigmoid(weights) if sigmoid_weights else torch.logaddexp(weights, torch.zeros_like(weights))
    n = directions.reshape(b, h, w, k, 2)
    # sqrt(sum(n^2)) as jnp.linalg.norm computes it: the same value, and the same non-finite gradient where a
    # predicted direction is exactly zero (ROADMAP section 3).
    n = divide_no_nan(n, torch.sqrt(torch.sum(n * n, dim=-1, keepdim=True)))
    ny, nx = n[..., 0], n[..., 1]
    a = 1.0 - ny * ny
    bb = -ny * nx
    d = 1.0 - nx * nx
    cy = ((torch.arange(h, dtype=dtype, device=hot.device) + 0.5) / h).view(1, h, 1, 1)
    cx = ((torch.arange(w, dtype=dtype, device=hot.device) + 0.5) / h).view(1, 1, w, 1)
    qy = a * cy + bb * cx
    qx = bb * cy + d * cx
    parts = [torch.einsum("bhwo,bhwk->bok", hot, f * wgt) for f in (a, bb, d, qy, qx)]
    parts.append(torch.einsum("bhwo,bhwk->bok", hot, wgt))
    return torch.stack(parts, dim=-1)


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
    plain = is_plain("voting")
    if raw_output is not None and not sigmoid_weights and (raw_output.is_cuda or plain):
        labels_f = filtered_labels(labels, hot)
        accumulate = voting_accumulate_plain if plain else voting_accumulate
        S = accumulate(raw_output.detach().to(torch.float32).contiguous(), labels_f, c, k)
    else:
        S = einsum_sums(hot, directions, weights, sigmoid_weights)
    return _solve_sums(S, h)
