"""Pre-activation ResNet18 backbone with output-stride-8 dilation.

Counterpart of ``casapose_tpu/models/resnet.py`` for resnet18: conv0 7x7/2
stem, pre-activation basic blocks, and the dilation switch that keeps every
stage after stride 8 at stride 1 with doubled dilation. Paddings are explicit
and symmetric, as in the JAX package. Module names are the flax names, flat
as flax has them, so that
:func:`casapose_tpu_torch.core.convert.from_jax_variables` maps weights by
name.

Returns the 5 feature maps the decoders consume, NCHW:
[x2s (relu0, s2), x4s (stage2 pre-act, s4), x8s (stage3 pre-act, s8),
 x16s (stage4 pre-act, s8), x32s (final bn+relu, s8)].
"""

import torch.nn as nn
import torch.nn.functional as F

from casapose_tpu_torch.models.layers import BatchNorm

RESNET18_REPETITIONS = (2, 2, 2, 2)


def _conv(cin, cout, kernel, stride, dilation, padding):
    return nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, dilation=dilation, bias=False)


class ResNet18(nn.Module):
    """Pre-activation resnet18 whose deep stages stay at 1/8 resolution."""

    def __init__(self):
        super().__init__()
        init_filters = 64
        self.bn_data = BatchNorm(3, scale=False)
        self.conv0 = _conv(3, init_filters, 7, 2, 1, 3)
        self.bn0 = BatchNorm(init_filters)
        self.blocks = []
        output_stride, current_stride, dilation = 8, 4, 1
        cin = init_filters
        for stage, rep in enumerate(RESNET18_REPETITIONS):
            filters = init_filters * 2**stage
            for block in range(rep):
                stride, cut = 1, "pre"
                if block == 0:
                    cut = "post"
                    if stage > 0:
                        if current_stride == output_stride:
                            dilation *= 2
                        else:
                            current_stride *= 2
                            stride = 2
                base = f"stage{stage + 1}_unit{block + 1}_"
                self.add_module(base + "bn1", BatchNorm(cin))
                if cut == "post":
                    self.add_module(base + "sc", _conv(cin, filters, 1, stride, 1, 0))
                self.add_module(base + "conv1", _conv(cin, filters, 3, stride, dilation, dilation))
                self.add_module(base + "bn2", BatchNorm(filters))
                self.add_module(base + "conv2", _conv(filters, filters, 3, 1, dilation, dilation))
                self.blocks.append((base, cut, block == 0 and stage > 0))
                cin = filters
        self.bn1 = BatchNorm(cin)
        self.out_channels = cin

    def forward(self, x):
        x = self.bn0(self.conv0(self.bn_data(x)))
        x2 = F.relu(x)
        output = [x2]
        x = F.max_pool2d(x2, 3, stride=2, padding=1)
        for base, cut, keep in self.blocks:
            x, x_temp = self._block(x, base, cut)
            if keep:
                output.append(x_temp)
        output.append(F.relu(self.bn1(x)))
        return output

    def _block(self, x, base, cut):
        """Pre-activation basic block; ``cut="post"`` adds a 1x1 projection shortcut."""
        layer = lambda name: getattr(self, base + name)  # noqa: E731
        x2 = F.relu(layer("bn1")(x))
        shortcut = x if cut == "pre" else layer("sc")(x2)
        h = F.relu(layer("bn2")(layer("conv1")(x2)))
        return layer("conv2")(h) + shortcut, x2
