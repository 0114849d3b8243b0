"""CASAPose's class-aware layers in PyTorch (inference).

Counterpart of ``casapose_tpu/models/layers.py``. Everything here works on
NCHW tensors: the model converts from the JAX package's NHWC layout at its
boundary. Argmax everywhere takes the first maximal index, as ``jnp.argmax``
does; ties are common on all-zero images.

Only what ``casapose_c_gcu5`` runs is here. ``ClassAdaptiveNorm``, the
``...WithInput`` norms, ``guided_bilinear_upsampling`` and the trainable
``HalfSize`` wait for the model variants that use them.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 2e-5

_OFFSETS_3X3 = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]


class BatchNorm(nn.Module):
    """Inference BatchNorm with the reference's eps, in flax's operation order.

    ``center``/``scale`` select the bias and scale parameters, as flax's
    ``use_bias``/``use_scale`` do. Running statistics are buffers named as
    torch names them. Batch statistics (training) are not ported yet.
    """

    def __init__(self, num_features, center=True, scale=True):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features)) if scale else None
        self.bias = nn.Parameter(torch.zeros(num_features)) if center else None
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        if self.training:
            raise NotImplementedError("casapose_tpu_torch ports inference only; call model.eval()")
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(self.running_var + BN_EPS)
        if self.weight is not None:
            mul = mul * self.weight
        y = (x - self.running_mean.view(shape)) * mul.view(shape)
        if self.bias is not None:
            y = y + self.bias.view(shape)
        return y


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
    """2x bilinear upsampling; equals ``jax.image.resize(..., "bilinear")`` at 2x, edges included."""
    return F.interpolate(x, size=(2 * x.shape[-2], 2 * x.shape[-1]), mode="bilinear", align_corners=False)


def half_size(x):
    """Stride-2 identity downsample (the fixed ``HalfSize``)."""
    return x[:, :, ::2, ::2]


class ClassAdaptiveWeightedNorm(nn.Module):
    """CLADE: parameter-free BatchNorm, then per-class gamma/beta selected per pixel."""

    def __init__(self, num_classes, channels):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(num_classes, channels))
        self.beta = nn.Parameter(torch.zeros(num_classes, channels))
        self.bn = BatchNorm(channels, center=False, scale=False)

    def forward(self, x, seg_onehot):
        gamma1 = torch.einsum("bchw,cf->bfhw", seg_onehot, self.gamma)
        beta1 = torch.einsum("bchw,cf->bfhw", seg_onehot, self.beta)
        return gamma1 * self.bn(x) + beta1


class PartialConv(nn.Module):
    """Class-aware partial 3x3 convolution.

    Without a mask it is a plain SAME 3x3 convolution with the same weight.
    With a one-hot mask, each of the 9 taps only sees neighbours whose argmax
    class equals the centre's, and the sum is rescaled by 9 over the exact
    number of such members (the JAX package's count, not the TF reference's
    phantom count, PARITY.md).
    """

    def __init__(self, in_channels, features):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_channels, 3, 3))

    def forward(self, x, seg_onehot=None):
        if seg_onehot is None:
            return F.conv2d(x, self.weight, padding=1)
        labels = torch.argmax(seg_onehot, dim=1, keepdim=True)
        out = None
        count = None
        for dy, dx in _OFFSETS_3X3:
            m = (shift2d(labels, dy, dx, fill=-1) == labels).to(x.dtype)
            contrib = F.conv2d(shift2d(x, dy, dx) * m, self.weight[:, :, dy + 1, dx + 1, None, None])
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


def guided_upsampling(x, seg_lo, seg_hi):
    """2x upsampling that copies the class-matching low-res neighbour.

    For each high-res pixel the candidates are the low-res pixels (i+a, j+b),
    a, b in {0, 1}; the first (row-major) whose label matches the high-res
    label wins, and with no match the nearest, (0, 0), is taken.
    """
    lab_lo = torch.argmax(seg_lo, dim=1, keepdim=True)
    lab_hi = torch.argmax(seg_hi, dim=1, keepdim=True)
    cands = [(shift2d(x, a, bb), shift2d(lab_lo, a, bb, fill=-1)) for a, bb in ((0, 0), (0, 1), (1, 0), (1, 1))]
    out_phases = []
    for lab_u in _split_phases(lab_hi):
        sel = cands[0][0]
        for cx, cl in reversed(cands):
            sel = torch.where(cl == lab_u, cx, sel)
        out_phases.append(sel)
    return _merge_phases(out_phases)
