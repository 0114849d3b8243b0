"""CASAPose twin-decoder models (every zoo variant) and the PVNet baseline.

Counterpart of ``casapose_tpu/models/casapose.py``. One ``CASAPoseModel`` is
parameterised by a :class:`VariantSpec` of per-layer
:class:`DecoderParams`, as in the JAX package: decoder 1 is conv + BatchNorm
+ (leaky) ReLU with bilinear 2x upsampling and skip concats, ending in the
segmentation logits; decoder 2 runs, layer by layer, a plain, partial or
shared convolution, CLADE or BatchNorm, and guided, guided-bilinear,
bilinear or nearest upsampling, conditioned on the hard one-hot mask
pyramid, ending in the vertex and confidence channels. ``PVNetModel`` is the
single-decoder baseline with one fused seg + vertex output conv.

The public layout is the JAX package's: ``forward`` takes an NHWC image and
returns ``[b, h, w, seg_dim + ver_dim]`` = ``[seg logits | vertex]`` (with
``output_labelmap``, ``[label | vertex]``). Inside, everything is NCHW.
Module names are the flax names. ``dtype=torch.bfloat16`` is the JAX
package's mixed-precision policy (models/layers.py); the seg logits and the
vertex output are float32 in both, so voting and PnP always see float32.
"""

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from casapose_tpu_torch.models.layers import (
    BatchNorm,
    ClassAdaptiveWeightedNorm,
    Conv,
    HalfSize,
    PartialConv,
    guided_bilinear_upsampling,
    guided_upsampling,
    hard_onehot,
    leaky_relu,
    resize_bilinear_2x,
    resize_nearest_2x,
)
from casapose_tpu_torch.models.resnet import ResNetBackbone


@dataclasses.dataclass(frozen=True)
class DecoderParams:
    """Per-layer decoder-2 configuration (mirrors the reference namedtuple)."""

    weighted_clade: bool = True
    partial_conv: bool = False
    guided_upsampling: bool = False
    bilinear_upsampling: bool = False
    reuse_conv: bool = False


@dataclasses.dataclass(frozen=True)
class VariantSpec:
    """Whole-model configuration distinguishing the zoo variants (see the JAX package's fields)."""

    decoder_params: Tuple[DecoderParams, ...]
    stop_gradient_mask: bool = True  # False only for casapose_c; the hard mask carries no gradient either way
    halfsize_trainable: bool = False  # True only for casapose_c
    decoder2_skip_connections: bool = True  # False for casapose_c_gcu5_sw1
    shared_reuse_with_mask: bool = True  # False: the generic builder (casapose_custom with decoder_params)
    reuse_first_with_mask: bool = False  # casapose_c_gcu4_sw2 re-applies the shared layer-1 conv with the mask
    pvnet: bool = False  # single fused decoder


def _skip_channels(backbone):
    """Channels of the features the decoders consume, in decoder order: [x32s, x8s, x4s, x2s, img]."""
    x2s, x4s, x8s, _, x32s = backbone.feature_channels
    return (x32s, x8s, x4s, x2s, 3)


def _at_least_f32(x):
    """A bf16 output as float32 (the JAX models' output dtype); float32 and float64 unchanged."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _activation(h, i):
    return leaky_relu(h, 0.1) if i > 0 else F.relu(h)


def _decoder_inputs(skip_channels, dims, i, skips=True):
    """Input channels of decoder layer ``i``: the backbone feature, after layer 0 with the previous output."""
    if i == 0:
        return skip_channels[0]
    return dims[i - 1] + (skip_channels[i] if skips else 0)


class CASAPoseModel(nn.Module):
    """Twin-decoder CASAPose network.

    ``forward(img [b, h, w, 3], gt_seg=None)``: ``gt_seg`` [b, h, w, seg_dim]
    (one-hot GT, the ``train_vectors_with_ground_truth`` mode) replaces the
    predicted segmentation as the mask that conditions decoder 2.
    """

    def __init__(self, spec, ver_dim, seg_dim, base_model="resnet18", fcdim=256, s8dim=128, s4dim=64, s2dim=32,
                 raw_dim=32, output_labelmap=False, dtype=None):
        super().__init__()
        self.spec = spec
        self.ver_dim = ver_dim
        self.seg_dim = seg_dim
        self.output_labelmap = output_labelmap
        self.dtype = dtype
        self.backbone = ResNetBackbone(base_model, dtype=dtype)
        skip = _skip_channels(self.backbone)
        dims = (fcdim, s8dim, s4dim, s2dim, raw_dim)
        # Registered layer by layer (decoder 1, then decoder 2), so that one seed draws the same weights for a
        # layer whatever the variant.
        for i, dp in enumerate(spec.decoder_params):
            cin = _decoder_inputs(skip, dims, i)
            if dp.reuse_conv:
                self.add_module(f"pv_block_{i + 1}_{i + 6}_conv2d", PartialConv(cin, dims[i]))
            else:
                self.add_module(f"pv_block_{i + 1}_conv2d", Conv(cin, dims[i], 3, padding=1, dtype=dtype))
            self.add_module(f"pv_block_{i + 1}_bn", BatchNorm(dims[i], dtype=dtype))
            if spec.pvnet:
                continue
            cin2 = _decoder_inputs(skip, dims, i, spec.decoder2_skip_connections)
            if dp.partial_conv and not dp.reuse_conv:
                self.add_module(f"pv_block_{i + 6}_conv2d", PartialConv(cin2, dims[i]))
            elif not dp.reuse_conv:
                self.add_module(f"pv_block_{i + 6}_conv2d", Conv(cin2, dims[i], 3, padding=1, dtype=dtype))
            if dp.weighted_clade:
                self.add_module(f"pv_block_{i + 6}_clade", ClassAdaptiveWeightedNorm(seg_dim, dims[i], dtype=dtype))
            else:
                self.add_module(f"pv_block_{i + 6}_bn", BatchNorm(dims[i], dtype=dtype))
        self.pv_final_conv_segmentation = Conv(raw_dim, seg_dim, 1, dtype=dtype)
        if spec.pvnet:
            self.pv_final_conv_vertex = Conv(raw_dim, ver_dim, 1)  # no compute dtype, as in the JAX package
            return
        self.segmentation_half_size = HalfSize(seg_dim, spec.halfsize_trainable)
        self.segmentation_quater_size = HalfSize(seg_dim, spec.halfsize_trainable)
        self.segmentation_eighth_size = HalfSize(seg_dim, spec.halfsize_trainable)
        self.pv_final_conv_vertex = Conv(raw_dim, ver_dim, 1, dtype=dtype)

    def forward(self, img, gt_seg=None):
        """img: [b, h, w, 3] float32 NHWC -> [b, h, w, seg_dim + ver_dim] float32 NHWC."""
        spec = self.spec
        img = img.permute(0, 3, 1, 2)
        if self.dtype is not None:
            img = img.to(self.dtype)
        x2s, x4s, x8s, _, x32s = self.backbone(img)
        skips = [x32s, x8s, x4s, x2s, img]

        x = None
        shared_out_0 = None
        for i, dp in enumerate(spec.decoder_params):
            inp = skips[0] if i == 0 else torch.cat([x, skips[i]], dim=1)
            if dp.reuse_conv:
                h = getattr(self, f"pv_block_{i + 1}_{i + 6}_conv2d")(inp)  # the plain SAME conv
                if i == 0:
                    shared_out_0 = h
            else:
                h = getattr(self, f"pv_block_{i + 1}_conv2d")(inp)
            h = _activation(getattr(self, f"pv_block_{i + 1}_bn")(h), i)
            x = resize_bilinear_2x(h) if 0 < i < 4 else h
        seg_logits = _at_least_f32(self.pv_final_conv_segmentation(x))

        x_mask = hard_onehot(seg_logits if gt_seg is None else gt_seg.permute(0, 3, 1, 2), dim=1)
        if spec.pvnet:
            return self._assemble(seg_logits, self.pv_final_conv_vertex(x), x_mask)

        m2 = self.segmentation_half_size(x_mask)
        m4 = self.segmentation_quater_size(m2)
        m8 = self.segmentation_eighth_size(m4)
        seg_masks = [m8, m8, m4, m2, x_mask, None]

        y = None
        for i, dp in enumerate(spec.decoder_params):
            n = i + 6
            if i == 0:
                inp = skips[0]
            elif spec.decoder2_skip_connections:
                inp = torch.cat([y, skips[i]], dim=1)
            else:
                inp = y
            if dp.reuse_conv:
                shared = getattr(self, f"pv_block_{i + 1}_{n}_conv2d")
                if i == 0:
                    h = shared(inp, seg_masks[0]) if spec.reuse_first_with_mask else shared_out_0
                elif spec.shared_reuse_with_mask:
                    h = shared(inp, seg_masks[i])
                else:
                    h = shared(inp)
            elif dp.partial_conv:
                h = getattr(self, f"pv_block_{n}_conv2d")(inp, seg_masks[i])
            else:
                h = getattr(self, f"pv_block_{n}_conv2d")(inp)
            if dp.weighted_clade:
                h = getattr(self, f"pv_block_{n}_clade")(h, seg_masks[i])
            else:
                h = getattr(self, f"pv_block_{n}_bn")(h)
            h = _activation(h, i)
            if 0 < i < 4:
                h = self._upsample(h, dp, seg_masks[i], seg_masks[i + 1])
            y = h
        vertex = _at_least_f32(self.pv_final_conv_vertex(y))
        return self._assemble(seg_logits, vertex, x_mask)

    @staticmethod
    def _upsample(h, dp, mask, guide):
        if not dp.weighted_clade:
            return resize_bilinear_2x(h)
        if dp.guided_upsampling:
            return (guided_bilinear_upsampling if dp.bilinear_upsampling else guided_upsampling)(h, mask, guide)
        return resize_bilinear_2x(h) if dp.bilinear_upsampling else resize_nearest_2x(h)

    def _assemble(self, seg_logits, vertex, x_mask):
        if self.output_labelmap:
            labels = torch.arange(self.seg_dim, dtype=x_mask.dtype, device=x_mask.device).view(1, -1, 1, 1)
            first = torch.sum(x_mask * labels, dim=1, keepdim=True)
        else:
            first = seg_logits
        return torch.cat([first, vertex], dim=1).permute(0, 2, 3, 1).contiguous()


class PVNetModel(nn.Module):
    """PVNet baseline: one decoder, then a fused seg + vertex 1x1 output conv (``pv_final_conv``)."""

    def __init__(self, ver_dim, seg_dim, base_model="resnet18", fcdim=256, s8dim=128, s4dim=64, s2dim=32,
                 raw_dim=32, output_labelmap=False, dtype=None):
        super().__init__()
        self.ver_dim = ver_dim
        self.seg_dim = seg_dim
        self.output_labelmap = output_labelmap
        self.dtype = dtype
        self.backbone = ResNetBackbone(base_model, dtype=dtype)
        skip = _skip_channels(self.backbone)
        dims = (fcdim, s8dim, s4dim, s2dim, raw_dim)
        for i in range(5):
            self.add_module(f"pv_block_{i + 1}_conv2d", Conv(_decoder_inputs(skip, dims, i), dims[i], 3, padding=1,
                                                             dtype=dtype))
            self.add_module(f"pv_block_{i + 1}_bn", BatchNorm(dims[i], dtype=dtype))
        self.pv_final_conv = Conv(raw_dim, seg_dim + ver_dim, 1, dtype=dtype)

    def forward(self, img, gt_seg=None):
        """img: [b, h, w, 3] NHWC -> [b, h, w, seg_dim + ver_dim] float32 NHWC (``gt_seg`` is unused, as in JAX)."""
        img = img.permute(0, 3, 1, 2)
        if self.dtype is not None:
            img = img.to(self.dtype)
        x2s, x4s, x8s, _, x32s = self.backbone(img)
        skips = [x32s, x8s, x4s, x2s, img]
        x = None
        for i in range(5):
            inp = skips[0] if i == 0 else torch.cat([x, skips[i]], dim=1)
            h = _activation(getattr(self, f"pv_block_{i + 1}_bn")(getattr(self, f"pv_block_{i + 1}_conv2d")(inp)), i)
            x = resize_bilinear_2x(h) if 0 < i < 4 else h
        out = _at_least_f32(self.pv_final_conv(x))
        if self.output_labelmap:
            labels = torch.arange(self.seg_dim, dtype=out.dtype, device=out.device).view(1, -1, 1, 1)
            first = torch.sum(hard_onehot(out[:, : self.seg_dim], dim=1) * labels, dim=1, keepdim=True)
            out = torch.cat([first, out[:, self.seg_dim :]], dim=1)
        return out.permute(0, 2, 3, 1).contiguous()


def init_weights(model, generator):
    """Initialise like the JAX package: he_uniform convs, BatchNorm and CLADE at identity, HalfSize at eye.

    Draws come from ``generator`` in the order of ``model.named_parameters()``,
    so one seed gives one set of weights on any device.
    """
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim == 4 and not name.startswith("segmentation_"):
                fan_in = p.shape[1] * p.shape[2] * p.shape[3]
                bound = (6.0 / fan_in) ** 0.5
                p.copy_(torch.rand(p.shape, generator=generator) * (2 * bound) - bound)
    return model
