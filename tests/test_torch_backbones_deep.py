"""resnet101 and resnet152 of the port against casapose_tpu's ``ResNetBackbone`` on the CPU.

The cases of tests/test_torch_backbones.py (full depth, 32x32 images, batch
2, rtol/atol 1e-4), kept in their own file: each of these JAX compiles is
long, and the suite spreads test files over workers.
"""

import pytest

from tests.test_torch_backbones import backbone_case


@pytest.mark.parametrize("name", ["resnet101", "resnet152"])
def test_deep_backbone_features_match(name):
    backbone_case(name)
