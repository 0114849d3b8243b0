"""CASAPose's class-aware layers in PyTorch.

Counterpart of ``casapose_tpu/models/layers.py``. Everything here works on
NCHW tensors: the model converts from the JAX package's NHWC layout at its
boundary. Argmax everywhere takes the first maximal index, as ``jnp.argmax``
does; ties are common on all-zero images.

Compute dtype. A layer built with ``dtype=torch.bfloat16`` computes as the
flax layer with ``dtype=jnp.bfloat16`` does: parameters stay float32 and are
cast where flax casts them, so the roundings fall in the same places:

  * ``Conv`` casts its input and kernel to the compute dtype (flax
    ``promote_dtype``); without one it promotes the input with the float32
    kernel, as a flax conv without ``dtype`` does;
  * ``BatchNorm`` computes ``(x - mean) * rsqrt(var + eps) * scale + bias``
    in float32 (flax's ``_normalize`` promotes against the float32
    statistics) and casts the result to the compute dtype;
  * CLADE casts gamma and beta to the input's dtype, ``PartialConv`` its
    kernel, and the elementwise sums of the upsamplers round in that dtype
    term by term, as XLA does;
  * the 2x bilinear resize rounds after its width pass and after its height
    pass, the order of ``jax.image.resize``'s two contractions.
"""

import contextlib
import contextvars

import torch
import torch.nn as nn
import torch.nn.functional as F

from casapose_tpu_torch.ops import quant
from casapose_tpu_torch.parallel.mesh import all_reduce_sum

BN_EPS = 2e-5
BN_MOMENTUM = 0.99

# True while a rematerialised forward runs again in the backward pass (``remat_context_fn``): BatchNorm then
# normalises with the batch statistics as before but leaves its running statistics alone, so they update once a
# step, as flax's do under jax.checkpoint.
_RECOMPUTING = contextvars.ContextVar("casapose_tpu_torch_recomputing", default=False)


@contextlib.contextmanager
def _recomputing():
    token = _RECOMPUTING.set(True)
    try:
        yield
    finally:
        _RECOMPUTING.reset(token)


def remat_context_fn():
    """The ``context_fn`` of ``torch.utils.checkpoint.checkpoint`` for the network forward: (the forward's context,
    the recompute's context, in which BatchNorm skips its running update)."""
    return contextlib.nullcontext(), _recomputing()

_OFFSETS_3X3 = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]


class Conv(nn.Conv2d):
    """Bias-free convolution with the flax compute-dtype rule (``dtype=None``: promote input and kernel).

    Inside ``ops/quant.py::quantized_convs`` it runs int8-quantized instead.
    """

    def __init__(self, cin, cout, kernel, stride=1, padding=0, dilation=1, dtype=None):
        super().__init__(cin, cout, kernel, stride=stride, padding=padding, dilation=dilation, bias=False)
        self.compute_dtype = dtype

    def forward(self, x):
        if quant.int8_active():
            return quant.quantize_conv_int8(self, x)
        dt = self.compute_dtype or torch.promote_types(x.dtype, self.weight.dtype)
        return self._conv_forward(x.to(dt), self.weight.to(dt), None)


class BatchNorm(nn.Module):
    """BatchNorm with the reference's eps and momentum, in flax's operation order.

    ``center``/``scale`` select the bias and scale parameters, as flax's
    ``use_bias``/``use_scale`` do. ``dtype`` is the result's dtype; without
    one it is the input's, promoted with the parameters' (flax's rule).
    Running statistics are buffers named as torch names them.

    In training mode (``module.train()``) it normalises with the batch
    statistics as flax 0.12 computes them: in float32 whatever the input's
    dtype, the mean and the *fast* variance ``E[x^2] - E[x]^2`` clipped at 0,
    the biased variance in the normalisation and in the running update
    ``ra = 0.99 * ra + 0.01 * batch``. The statistics are plain tensor ops,
    so gradients flow through the mean and the variance as JAX's do.

    Under a data-parallel group of several ranks (``data_parallel``, set by
    ``parallel/mesh.py::sync_batchnorm``) the statistics are those of the
    global batch, as JAX's sharded reduction computes them: the per-channel
    sums of x and x^2 and the element count are summed over the ranks (the
    sum carries the gradient), then the same fast variance is taken. A
    rematerialised forward (:func:`remat_context_fn`) skips the running update.
    """

    def __init__(self, num_features, center=True, scale=True, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features)) if scale else None
        self.bias = nn.Parameter(torch.zeros(num_features)) if center else None
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.dtype = dtype
        self.data_parallel = None

    def _global_moments(self, xf):
        count = torch.full((1,), xf.numel() // xf.shape[1], dtype=xf.dtype, device=xf.device)
        sums = all_reduce_sum(torch.cat([xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3)), count]),
                              self.data_parallel)
        c = xf.shape[1]
        mean = sums[:c] / sums[-1]
        return mean, sums[c : 2 * c] / sums[-1]

    def forward(self, x):
        shape = (1, -1, 1, 1)
        if self.training:
            xf = x.to(torch.promote_types(x.dtype, torch.float32))
            if self.data_parallel is None:
                mean = xf.mean(dim=(0, 2, 3))
                mean_sq = torch.mean(xf * xf, dim=(0, 2, 3))
            else:
                mean, mean_sq = self._global_moments(xf)
            var = torch.clamp(mean_sq - mean * mean, min=0.0)
            if not _RECOMPUTING.get():
                with torch.no_grad():
                    self.running_mean.copy_(BN_MOMENTUM * self.running_mean + (1.0 - BN_MOMENTUM) * mean)
                    self.running_var.copy_(BN_MOMENTUM * self.running_var + (1.0 - BN_MOMENTUM) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + BN_EPS)
        if self.weight is not None:
            mul = mul * self.weight
        y = (x - mean.view(shape)) * mul.view(shape)
        if self.bias is not None:
            y = y + self.bias.view(shape)
        has_params = self.weight is not None or self.bias is not None
        return y.to(self.dtype or (torch.promote_types(x.dtype, torch.float32) if has_params else x.dtype))


def leaky_relu(x, slope=0.1):
    """flax's ``where(x >= 0, x, slope * x)``; in bfloat16 the slope is rounded to bfloat16 first, as XLA does."""
    if x.dtype == torch.float32:
        return F.leaky_relu(x, slope)
    return torch.where(x >= 0, x, x * torch.tensor(slope, dtype=x.dtype, device=x.device))


def hard_onehot(logits, dim=1):
    """one_hot(argmax(logits)) along ``dim``, first maximum on ties."""
    idx = torch.argmax(logits, dim=dim)
    return F.one_hot(idx, logits.shape[dim]).movedim(-1, dim).to(logits.dtype)


def shift2d(x, dy, dx, fill=0):
    """Shifted view of an NCHW tensor: out[..., y, x] = in[..., y + dy, x + dx], ``fill`` outside."""
    if dy == 0 and dx == 0:
        return x
    h, w = x.shape[-2], x.shape[-1]
    padded = F.pad(x, (max(-dx, 0), max(dx, 0), max(-dy, 0), max(dy, 0)), value=fill)
    y0, x0 = max(dy, 0), max(dx, 0)
    return padded[..., y0 : y0 + h, x0 : x0 + w]


def resize_bilinear_2x(x):
    """2x bilinear upsampling; equals ``jax.image.resize(..., "bilinear")`` at 2x, edges included.

    In float32 one interpolation. In a narrower dtype the width pass and the
    height pass each compute in float32 and round, the order and rounding of
    ``jax.image.resize``'s two contractions (each output is a two-term sum
    with weights 1/4 and 3/4, exact in float32 before its one rounding).
    """
    h, w = x.shape[-2], x.shape[-1]
    if x.dtype == torch.float32:
        return F.interpolate(x, size=(2 * h, 2 * w), mode="bilinear", align_corners=False)
    wide = F.interpolate(x.float(), size=(h, 2 * w), mode="bilinear", align_corners=False).to(x.dtype)
    return F.interpolate(wide.float(), size=(2 * h, 2 * w), mode="bilinear", align_corners=False).to(x.dtype)


def resize_nearest_2x(x):
    """2x nearest upsampling (``jnp.repeat`` on both axes)."""
    return x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


def half_size(x):
    """Stride-2 identity downsample (the fixed ``HalfSize``)."""
    return x[:, :, ::2, ::2]


class HalfSize(nn.Module):
    """Stride-2 downsample; ``trainable``: then an eye-initialised ``depth x depth`` channel matrix.

    The JAX package keeps that matrix as a (1, 1, depth, depth) HWIO kernel
    and applies ``x @ kernel[0, 0]``; here it is the same kernel as a 1x1
    convolution weight (OIHW), so the weight bridge's conv rule maps it.
    """

    def __init__(self, depth, trainable=False):
        super().__init__()
        self.trainable = trainable
        if trainable:
            self.weight = nn.Parameter(torch.eye(depth).reshape(depth, depth, 1, 1))

    def forward(self, x):
        x = half_size(x)
        if not self.trainable:
            return x
        return torch.einsum("bihw,oi->bohw", x, self.weight[:, :, 0, 0].to(x.dtype))


class ClassAdaptiveWeightedNorm(nn.Module):
    """CLADE: parameter-free BatchNorm, then per-class gamma/beta selected per pixel."""

    def __init__(self, num_classes, channels, dtype=None):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(num_classes, channels))
        self.beta = nn.Parameter(torch.zeros(num_classes, channels))
        self.bn = BatchNorm(channels, center=False, scale=False, dtype=dtype)

    def forward(self, x, seg_onehot):
        seg = seg_onehot.to(x.dtype)
        gamma1 = torch.einsum("bchw,cf->bfhw", seg, self.gamma.to(x.dtype))
        beta1 = torch.einsum("bchw,cf->bfhw", seg, self.beta.to(x.dtype))
        return gamma1 * self.bn(x) + beta1


class ClassAdaptiveNorm(nn.Module):
    """Hard-label CLADE: an integer label map [b, h, w] selects the gamma/beta rows."""

    def __init__(self, num_classes, channels):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(num_classes, channels))
        self.beta = nn.Parameter(torch.zeros(num_classes, channels))
        self.bn = BatchNorm(channels, center=False, scale=False)

    def forward(self, x, seg_labels):
        gamma1 = self.gamma.to(x.dtype)[seg_labels].permute(0, 3, 1, 2)
        beta1 = self.beta.to(x.dtype)[seg_labels].permute(0, 3, 1, 2)
        return gamma1 * self.bn(x) + beta1


class ClassAdaptiveWeightedNormWithInput(nn.Module):
    """CLADE with per-image gamma/beta [b, C, ch] given as inputs.

    ``learned_blend`` (the ``...WithInputAndLearnedParameters`` variant)
    blends them with learned per-class parameters by the clipped weights
    ``alpha_1`` and ``alpha_2``.
    """

    def __init__(self, num_classes, channels, learned_blend=False):
        super().__init__()
        self.learned_blend = learned_blend
        if learned_blend:
            self.gamma = nn.Parameter(torch.ones(num_classes, channels))
            self.beta = nn.Parameter(torch.zeros(num_classes, channels))
            self.alpha_1 = nn.Parameter(torch.full((1,), 0.5))
            self.alpha_2 = nn.Parameter(torch.full((1,), 0.5))
        self.bn = BatchNorm(channels, center=False, scale=False)

    def forward(self, x, seg_onehot, gamma_in, beta_in):
        gamma1 = torch.einsum("bchw,bcf->bfhw", seg_onehot, gamma_in.to(x.dtype))
        beta1 = torch.einsum("bchw,bcf->bfhw", seg_onehot, beta_in.to(x.dtype))
        if self.learned_blend:
            a1 = torch.clamp(self.alpha_1, 0.0, 1.0)
            a2 = torch.clamp(self.alpha_2, 0.0, 1.0)
            gamma2 = torch.einsum("bchw,cf->bfhw", seg_onehot, self.gamma.to(x.dtype))
            beta2 = torch.einsum("bchw,cf->bfhw", seg_onehot, self.beta.to(x.dtype))
            gamma1 = a1 * gamma1 + (1.0 - a1) * gamma2
            beta1 = a2 * beta1 + (1.0 - a2) * beta2
        return gamma1 * self.bn(x) + beta1


class PartialConv(nn.Module):
    """Class-aware partial 3x3 convolution.

    Without a mask it is a plain SAME 3x3 convolution with the same weight
    (how the decoders share a conv). With a one-hot mask, each of the 9
    taps only sees neighbours whose argmax class equals the centre's, and
    the sum is rescaled by 9 over the exact number of such members (the JAX
    package's count, not the TF reference's phantom count, PARITY.md). The
    kernel is cast to the input's dtype, and the taps are summed in it.
    Inside ``ops/quant.py::quantized_convs`` it runs int8-quantized instead.
    """

    def __init__(self, in_channels, features):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_channels, 3, 3))

    def forward(self, x, seg_onehot=None):
        if quant.int8_active():
            return quant.quantize_partial_conv_int8(self, x, seg_onehot)
        weight = self.weight.to(x.dtype)
        if seg_onehot is None:
            return F.conv2d(x, weight, padding=1)
        labels = torch.argmax(seg_onehot, dim=1, keepdim=True)
        out = None
        count = None
        for dy, dx in _OFFSETS_3X3:
            m = (shift2d(labels, dy, dx, fill=-1) == labels).to(x.dtype)
            contrib = F.conv2d(shift2d(x, dy, dx) * m, weight[:, :, dy + 1, dx + 1, None, None])
            out = contrib if out is None else out + contrib
            count = m if count is None else count + m
        return out * (9.0 / torch.clamp(count, min=1.0))


def _split_phases(hi):
    """[b, c, 2h, 2w] -> 4 phase maps [b, c, h, w] for (di, dj) in 2x2."""
    return [hi[:, :, di::2, dj::2] for di in (0, 1) for dj in (0, 1)]


def _merge_phases(phases):
    """Inverse of :func:`_split_phases`."""
    b, c, h2, w2 = phases[0].shape
    stacked = torch.stack(phases, dim=-1).view(b, c, h2, w2, 2, 2)
    return stacked.permute(0, 1, 2, 4, 3, 5).reshape(b, c, 2 * h2, 2 * w2)


def _candidates(x, seg_lo, seg_hi):
    """The 4 low-res candidates (i+a, j+b) with their labels, and the high-res label phases."""
    lab_lo = torch.argmax(seg_lo, dim=1, keepdim=True)
    lab_hi = torch.argmax(seg_hi, dim=1, keepdim=True)
    cands = [(shift2d(x, a, bb), shift2d(lab_lo, a, bb, fill=-1)) for a, bb in ((0, 0), (0, 1), (1, 0), (1, 1))]
    return cands, _split_phases(lab_hi)


def guided_upsampling(x, seg_lo, seg_hi):
    """2x upsampling that copies the class-matching low-res neighbour.

    For each high-res pixel the candidates are the low-res pixels (i+a, j+b),
    a, b in {0, 1}; the first (row-major) whose label matches the high-res
    label wins, and with no match the nearest, (0, 0), is taken.
    """
    cands, phases = _candidates(x, seg_lo, seg_hi)
    out_phases = []
    for lab_u in phases:
        sel = cands[0][0]
        for cx, cl in reversed(cands):
            sel = torch.where(cl == lab_u, cx, sel)
        out_phases.append(sel)
    return _merge_phases(out_phases)


_BILINEAR_WEIGHTS = ((1.0, 0.0, 0.0, 0.0), (0.5, 0.5, 0.0, 0.0), (0.5, 0.0, 0.5, 0.0), (0.25, 0.25, 0.25, 0.25))


def guided_bilinear_upsampling(x, seg_lo, seg_hi):
    """2x bilinear upsampling restricted to class-matching neighbours.

    A candidate whose label differs from the high-res pixel's is replaced by
    the mean of the matching ones (0 with none) before the bilinear weights
    of the output phase apply. Sums run term by term in the input's dtype,
    in the JAX package's order.
    """
    cands, phases = _candidates(x, seg_lo, seg_hi)
    out_phases = []
    for q, lab_u in enumerate(phases):
        matches = [(cl == lab_u).to(x.dtype) for _, cl in cands]
        norm = sum(matches)
        total = sum(cx * m for (cx, _), m in zip(cands, matches))
        mean_match = torch.where(norm > 0, total / torch.clamp(norm, min=1.0), torch.zeros_like(total))
        vals = [torch.where(m > 0, cx, mean_match) for (cx, _), m in zip(cands, matches)]
        out_phases.append(sum(v * _BILINEAR_WEIGHTS[q][i] for i, v in enumerate(vals)))
    return _merge_phases(out_phases)
