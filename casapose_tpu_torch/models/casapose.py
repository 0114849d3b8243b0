"""The CASAPose twin-decoder network at the ``casapose_c_gcu5`` wiring.

Counterpart of ``casapose_tpu/models/casapose.py::CASAPoseModel`` for the
flagship spec: decoder 1 is conv + BatchNorm + (leaky) ReLU with bilinear 2x
upsampling and skip concats, ending in the segmentation logits; decoder 2
runs partial convolution, CLADE and guided upsampling on every layer,
conditioned on the hard one-hot mask pyramid, ending in the vertex and
confidence channels.

The public layout is the JAX package's: ``forward`` takes an NHWC image and
returns ``[b, h, w, seg_dim + ver_dim]`` = ``[seg logits | vertex]``. Inside,
everything is NCHW. Module names are the flax names.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from casapose_tpu_torch.models.layers import (
    BatchNorm,
    ClassAdaptiveWeightedNorm,
    PartialConv,
    guided_upsampling,
    half_size,
    hard_onehot,
    resize_bilinear_2x,
)
from casapose_tpu_torch.models.resnet import ResNet18

# Channels of the backbone features the decoders consume, in decoder order:
# [x32s, x8s, x4s, x2s, img].
_SKIP_CHANNELS = (512, 128, 64, 64, 3)


class CASAPoseGCU5(nn.Module):
    """``casapose_c_gcu5``: resnet18 backbone and two decoders, inference only."""

    def __init__(self, ver_dim, seg_dim, fcdim=256, s8dim=128, s4dim=64, s2dim=32, raw_dim=32):
        super().__init__()
        self.ver_dim = ver_dim
        self.seg_dim = seg_dim
        self.backbone = ResNet18()
        dims = (fcdim, s8dim, s4dim, s2dim, raw_dim)
        for i, cout in enumerate(dims):
            cin = _SKIP_CHANNELS[0] if i == 0 else dims[i - 1] + _SKIP_CHANNELS[i]
            self.add_module(f"pv_block_{i + 1}_conv2d", nn.Conv2d(cin, cout, 3, padding=1, bias=False))
            self.add_module(f"pv_block_{i + 1}_bn", BatchNorm(cout))
            self.add_module(f"pv_block_{i + 6}_conv2d", PartialConv(cin, cout))
            self.add_module(f"pv_block_{i + 6}_clade", ClassAdaptiveWeightedNorm(seg_dim, cout))
        self.pv_final_conv_segmentation = nn.Conv2d(raw_dim, seg_dim, 1, bias=False)
        self.pv_final_conv_vertex = nn.Conv2d(raw_dim, ver_dim, 1, bias=False)

    def forward(self, img):
        """img: [b, h, w, 3] float32 NHWC -> [b, h, w, seg_dim + ver_dim] NHWC."""
        img = img.permute(0, 3, 1, 2)
        x2s, x4s, x8s, _, x32s = self.backbone(img)
        skips = [x32s, x8s, x4s, x2s, img]
        layer = lambda name: getattr(self, name)  # noqa: E731

        x = None
        for i in range(5):
            inp = skips[0] if i == 0 else torch.cat([x, skips[i]], dim=1)
            h = layer(f"pv_block_{i + 1}_bn")(layer(f"pv_block_{i + 1}_conv2d")(inp))
            h = F.leaky_relu(h, 0.1) if i > 0 else F.relu(h)
            x = resize_bilinear_2x(h) if 0 < i < 4 else h
        seg_logits = self.pv_final_conv_segmentation(x)

        x_mask = hard_onehot(seg_logits, dim=1)
        m2 = half_size(x_mask)
        m4 = half_size(m2)
        m8 = half_size(m4)
        masks = [m8, m8, m4, m2, x_mask]
        guides = [None, m4, m2, x_mask, None]

        y = None
        for i in range(5):
            inp = skips[0] if i == 0 else torch.cat([y, skips[i]], dim=1)
            h = layer(f"pv_block_{i + 6}_conv2d")(inp, masks[i])
            h = layer(f"pv_block_{i + 6}_clade")(h, masks[i])
            h = F.leaky_relu(h, 0.1) if i > 0 else F.relu(h)
            y = guided_upsampling(h, masks[i], guides[i]) if guides[i] is not None else h
        vertex = self.pv_final_conv_vertex(y)
        return torch.cat([seg_logits, vertex], dim=1).permute(0, 2, 3, 1).contiguous()


def init_weights(model, generator):
    """Initialise like the JAX package: he_uniform convs, BatchNorm and CLADE at identity.

    Draws come from ``generator`` in the order of ``model.named_parameters()``,
    so one seed gives one set of weights on any device.
    """
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim == 4:
                fan_in = p.shape[1] * p.shape[2] * p.shape[3]
                bound = (6.0 / fan_in) ** 0.5
                p.copy_(torch.rand(p.shape, generator=generator) * (2 * bound) - bound)
    return model
