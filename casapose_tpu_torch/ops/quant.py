"""Int8 dynamic-quantized inference.

Counterpart of ``casapose_tpu/ops/quant.py``. Inside :func:`quantized_convs`
(or through :func:`quantized_apply`) every ``models/layers.py::Conv`` (the
backbone's, the decoders' and the final heads') and every ``PartialConv``
(masked and unmasked) computes its convolution on int8 codes; the same layers
that flax's interceptor reaches in the JAX package. BatchNorm, CLADE, the
upsamplers, voting and PnP keep their dtype.

  * weights: per-output-channel symmetric scales ``max|w| / 127`` (floored at
    1e-12), codes ``round(w / scale)``;
  * activations: one scale per image, ``max|x| / 127``; codes
    ``clip(round(x / scale), -127, 127)``, rounding half to even as
    ``jnp.round`` does. A per-image scale keeps each image independent of its
    batch neighbours, so a batch gives the same bits as its images one by one;
  * the product: s8 x s8 summed into int32, then one float32 rescale by
    ``x_scale * w_scale`` (that product first, as in the JAX package) and a
    cast back to the input's dtype.

The int32 sums are exact, so from the same codes they are bit-identical on the
card, on the CPU and in the JAX package.

This is not a port of a TPU kernel: the JAX package leaves the product to XLA
(``lax.conv_general_dilated(..., preferred_element_type=int32)``, outside any
Pallas kernel). Here it is PyTorch's int8 GEMM, ``torch._int_mm`` (cuBLASLt's
IMMA path on the card), fed with an im2col of the int8 codes built from the
module's stride, padding and dilation. ``_int_mm`` on CUDA wants more than 16
rows and inner and output widths that are multiples of 8: zero codes pad the
rows, the taps and the output channels (they add nothing to the int32 sums)
and the result is sliced. The im2col is built from codes that are already
int8, a few images at a time (at most ``_IM2COL_BYTES`` of codes), so a 3x3
convolution at batch 32 and 480x640 does not hold its whole 9x-wide input.

The reference has no quantized path (TF2/Keras float32 end to end); like the
JAX package's, this path is inference only.
"""

import contextlib
import contextvars

import torch
import torch.nn.functional as F

_INT8 = contextvars.ContextVar("casapose_tpu_torch_int8_convs", default=False)

# Codes of one im2col chunk: whole images, at most this many bytes (one image may exceed it alone).
_IM2COL_BYTES = 1 << 28


@contextlib.contextmanager
def quantized_convs():
    """Every ``Conv`` and ``PartialConv`` forward inside runs int8-quantized (per thread and asyncio task)."""
    token = _INT8.set(True)
    try:
        yield
    finally:
        _INT8.reset(token)


def int8_active():
    """Whether the convolutions run int8-quantized here (read by the two layers' ``forward``)."""
    return _INT8.get()


def quantized_apply(model, img, gt_seg=None):
    """``model(img, gt_seg)`` with every convolution int8-quantized, in eval mode and without gradients.

    The model's mode is restored afterwards. Inference only, as the JAX
    package's ``quantized_apply`` (it forces ``train=False``).
    """
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad(), quantized_convs():
            return model(img, gt_seg)
    finally:
        model.train(was_training)


def _scale(absmax):
    """``max(absmax, 1e-12) / 127`` as a true division on every device: CUDA turns a division by a Python number
    into a product with its reciprocal, which can differ in the last bit (and move a code at a tie)."""
    return torch.clamp(absmax, min=1e-12) / torch.full((), 127.0, device=absmax.device)


def weight_codes(weight):
    """Per-output-channel codes of an OIHW weight: (int8 codes, float32 scales [O])."""
    w = weight.detach().to(torch.float32)
    w_scale = _scale(w.abs().amax(dim=(1, 2, 3)))
    return torch.round(w / w_scale[:, None, None, None]).to(torch.int8), w_scale


def activation_codes(x):
    """Per-image codes of an NCHW activation: (int8 codes NCHW, float32 scales [B])."""
    x32 = x.detach().to(torch.float32)
    x_scale = _scale(x32.abs().amax(dim=(1, 2, 3)))
    return torch.clamp(torch.round(x32 / x_scale[:, None, None, None]), -127, 127).to(torch.int8), x_scale


def _round8(n):
    return -(-n // 8) * 8


def int8_matmul(cols, wq2):
    """int32 [M, O] = cols [M, K] @ wq2 [O, K]^T by ``torch._int_mm``, zero-padded to its shape rules."""
    m, k = cols.shape
    o = wq2.shape[0]
    kp, op, mp = _round8(k), _round8(o), max(m, 17)
    if kp != k or mp != m:
        cols = F.pad(cols, (0, kp - k, 0, mp - m))
    if kp != k or op != o:
        wq2 = F.pad(wq2, (0, kp - k, 0, op - o))
    acc = torch._int_mm(cols.contiguous(), wq2.t())
    return acc[:m, :o]


def _chunks(b, per_image_bytes):
    step = max(1, _IM2COL_BYTES // max(per_image_bytes, 1))
    return [(i, min(i + step, b)) for i in range(0, b, step)]


def conv_accumulators(xq, wq, stride, padding, dilation):
    """int32 sums [B, Ho, Wo, O] of a convolution of codes ``xq`` [B, C, H, W] with codes ``wq`` [O, C, kh, kw]."""
    b, c, h, w = xq.shape
    o, _, kh, kw = wq.shape
    (sh, sw), (ph, pw), (dh, dw) = stride, padding, dilation
    ho = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    wo = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    wq2 = wq.permute(0, 2, 3, 1).reshape(o, kh * kw * c)  # (tap, channel) order, as the columns below
    x = F.pad(xq, (pw, pw, ph, ph)).permute(0, 2, 3, 1)  # NHWC codes
    out = []
    for i0, i1 in _chunks(b, ho * wo * kh * kw * c):
        xs = x[i0:i1]
        taps = [xs[:, i * dh : i * dh + (ho - 1) * sh + 1 : sh, j * dw : j * dw + (wo - 1) * sw + 1 : sw]
                for i in range(kh) for j in range(kw)]
        cols = taps[0] if len(taps) == 1 else torch.cat(taps, dim=-1)
        out.append(int8_matmul(cols.reshape(-1, kh * kw * c), wq2).view(i1 - i0, ho, wo, o))
    return out[0] if len(out) == 1 else torch.cat(out)


def partial_conv_accumulators(xq, wq, labels):
    """int32 sums [B, H, W, O] of the class-masked 3x3 stencil on codes ``xq`` [B, C, H, W].

    ``labels`` [B, 1, H, W] are the argmax classes: tap (dy, dx) sees the
    shifted code only where the neighbour's class equals the centre's (the
    0/1 mask multiplies int8 codes, the shift fills with the exact 0 code), so
    the 9 taps' int32 products sum exactly, in any order. Returns (sums, the
    float32 count of matching taps [B, 1, H, W]).
    """
    from casapose_tpu_torch.models.layers import _OFFSETS_3X3, shift2d

    b, c, h, w = xq.shape
    o = wq.shape[0]
    wq2 = wq.permute(0, 2, 3, 1).reshape(o, 9 * c)  # taps in _OFFSETS_3X3 order: (dy + 1) * 3 + (dx + 1)
    masks = [shift2d(labels, dy, dx, fill=-1) == labels for dy, dx in _OFFSETS_3X3]
    count = sum(m.to(torch.float32) for m in masks)
    out = []
    for i0, i1 in _chunks(b, h * w * 9 * c):
        taps = [torch.where(m[i0:i1], shift2d(xq[i0:i1], dy, dx), torch.zeros((), dtype=torch.int8, device=xq.device))
                for m, (dy, dx) in zip(masks, _OFFSETS_3X3)]
        cols = torch.stack(taps, dim=1).permute(0, 3, 4, 1, 2).reshape(-1, 9 * c)  # [b h w, (tap, channel)]
        out.append(int8_matmul(cols, wq2).view(i1 - i0, h, w, o))
    return (out[0] if len(out) == 1 else torch.cat(out)), count


def _rescale(acc, x_scale, w_scale):
    """float32 [B, O, H, W] = acc * (x_scale * w_scale), the scales' product taken first."""
    return (acc.to(torch.float32) * (x_scale[:, None, None, None] * w_scale)).permute(0, 3, 1, 2)


def quantize_conv_int8(mod, x):
    """A ``Conv``'s (bias-free ``nn.Conv2d``'s) convolution as s8 x s8 -> s32 on NCHW ``x``; the input's dtype out."""
    if mod.groups != 1 or mod.bias is not None or mod.padding_mode != "zeros" or isinstance(mod.padding, str):
        raise ValueError("quantize_conv_int8: a bias-free, ungrouped convolution with explicit zero padding only")
    xq, x_scale = activation_codes(x)
    wq, w_scale = weight_codes(mod.weight)
    acc = conv_accumulators(xq, wq, mod.stride, mod.padding, mod.dilation)
    return _rescale(acc, x_scale, w_scale).to(x.dtype)


def quantize_partial_conv_int8(mod, x, seg_onehot=None):
    """Int8 ``PartialConv``: without a mask a plain SAME 3x3; with one the masked stencil, 9/count after the
    rescale, as the float layer normalises."""
    xq, x_scale = activation_codes(x)
    wq, w_scale = weight_codes(mod.weight)
    if seg_onehot is None:
        return _rescale(conv_accumulators(xq, wq, (1, 1), (1, 1), (1, 1)), x_scale, w_scale).to(x.dtype)
    acc, count = partial_conv_accumulators(xq, wq, torch.argmax(seg_onehot, dim=1, keepdim=True))
    out = _rescale(acc, x_scale, w_scale)
    return (out * (9.0 / torch.clamp(count, min=1.0))).to(x.dtype)
