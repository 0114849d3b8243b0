"""Pre-activation ResNet backbones (resnet18 to resnet152) with output-stride-8 dilation.

Counterpart of ``casapose_tpu/models/resnet.py``: conv0 7x7/2 stem,
pre-activation basic (resnet18/34) or bottleneck (resnet50/101/152) blocks,
and the dilation switch that keeps every stage after stride 8 at stride 1
with doubled dilation. Paddings are explicit and symmetric, as in the JAX
package. Module names are the flax names, flat as flax has them, so that
:func:`casapose_tpu_torch.core.convert.from_jax_variables` maps weights by
name.

Returns the 5 feature maps the decoders consume, NCHW:
[x2s (relu0, s2), x4s (stage2 pre-act, s4), x8s (stage3 pre-act, s8),
 x16s (stage4 pre-act, s8), x32s (final bn+relu, s8)]; their channels are
``feature_channels``: (64, 64, 128, 256, 512) for basic blocks, (64, 256,
512, 1024, 2048) for bottlenecks.
"""

import torch.nn as nn
import torch.nn.functional as F

from casapose_tpu_torch.models.layers import BatchNorm, Conv

RESNET_PARAMS = {
    "resnet18": ((2, 2, 2, 2), False),
    "resnet34": ((3, 4, 6, 3), False),
    "resnet50": ((3, 4, 6, 3), True),
    "resnet101": ((3, 4, 23, 3), True),
    "resnet152": ((3, 8, 36, 3), True),
}


class ResNetBackbone(nn.Module):
    """Pre-activation ResNet whose deep stages stay at 1/8 resolution; ``dtype`` is the compute dtype."""

    def __init__(self, model_name="resnet18", dtype=None):
        super().__init__()
        if model_name not in RESNET_PARAMS:
            raise KeyError(f"No such backbone `{model_name}`, available backbones: {sorted(RESNET_PARAMS)}")
        repetitions, bottleneck = RESNET_PARAMS[model_name]
        expansion = 4 if bottleneck else 1
        init_filters = 64
        self.dtype = dtype
        self.bottleneck = bottleneck
        self.bn_data = BatchNorm(3, scale=False, dtype=dtype)
        self.conv0 = Conv(3, init_filters, 7, 2, 3, dtype=dtype)
        self.bn0 = BatchNorm(init_filters, dtype=dtype)
        self.blocks = []
        output_stride, current_stride, dilation = 8, 4, 1
        cin = init_filters
        channels = [init_filters]
        for stage, rep in enumerate(repetitions):
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
                        channels.append(cin)
                base = f"stage{stage + 1}_unit{block + 1}_"
                self.add_module(base + "bn1", BatchNorm(cin, dtype=dtype))
                if cut == "post":
                    self.add_module(base + "sc", Conv(cin, filters * expansion, 1, stride, dtype=dtype))
                if bottleneck:
                    self.add_module(base + "conv1", Conv(cin, filters, 1, dtype=dtype))
                    self.add_module(base + "bn2", BatchNorm(filters, dtype=dtype))
                    self.add_module(base + "conv2", Conv(filters, filters, 3, stride, dilation, dilation, dtype=dtype))
                    self.add_module(base + "bn3", BatchNorm(filters, dtype=dtype))
                    self.add_module(base + "conv3", Conv(filters, filters * expansion, 1, dtype=dtype))
                else:
                    self.add_module(base + "conv1", Conv(cin, filters, 3, stride, dilation, dilation, dtype=dtype))
                    self.add_module(base + "bn2", BatchNorm(filters, dtype=dtype))
                    self.add_module(base + "conv2", Conv(filters, filters, 3, 1, dilation, dilation, dtype=dtype))
                self.blocks.append((base, cut, block == 0 and stage > 0))
                cin = filters * expansion
        self.bn1 = BatchNorm(cin, dtype=dtype)
        self.feature_channels = tuple(channels + [cin])

    def forward(self, x):
        if self.dtype is not None:
            x = x.to(self.dtype)
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
        """Pre-activation block; ``cut="post"`` takes a 1x1 projection shortcut of the pre-activated input."""
        layer = lambda name: getattr(self, base + name)  # noqa: E731
        x2 = F.relu(layer("bn1")(x))
        shortcut = x if cut == "pre" else layer("sc")(x2)
        h = F.relu(layer("bn2")(layer("conv1")(x2)))
        if self.bottleneck:
            h = F.relu(layer("bn3")(layer("conv2")(h)))
            h = layer("conv3")(h)
        else:
            h = layer("conv2")(h)
        return h + shortcut, x2
