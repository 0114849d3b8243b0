"""``CASAPOSE_VOTING_FORM`` in the port (``casapose_tpu_torch/ops/voting.py``) against the JAX package's forms.

The scene is tests/test_voting_bf16c.py's worst case (near-parallel directions
on narrow blobs, 96x128, 3 objects, 5 keypoints), the same numpy arrays for
both packages, each form set with ``monkeypatch.setenv`` for both.

Tolerances, and why:
  * ``multi``, ``stack`` and ``concat`` are XLA layouts of the same float32
    sums; the port computes all three with its einsum form. They agree with
    JAX within the float64 parity band of tests/test_tf_parity.py, 1e-3 px
    (measured 5e-5 to 9e-5 px);
  * ``bf16c`` rounds the centred features and the class mask to bfloat16 and
    sums in float32, so a float32 difference of one ulp in a feature can round
    to another bfloat16 value: 1e-3 px (measured 3e-5 px), while both stay
    within 1 px of the float64 oracle (tests/test_voting_bf16c.py's bound);
  * with ``raw_output`` the form is still ``bf16c`` (it replaces the voting
    kernel, as in the JAX package's default path): bit for bit the call without.
"""

import numpy as np
import pytest

from tests.test_voting_bf16c import _f64_oracle, _scene
from tests.torch_parity import single_torch_thread  # noqa: F401 (autouse: one torch thread)

K = 5


@pytest.fixture(scope="module")
def scene():
    seg, dirs, conf, _ = _scene(seed=3, k=K)
    return seg, dirs, conf, _f64_oracle(seg, dirs, conf, K)


@pytest.mark.parametrize("form", ["multi", "stack", "concat", "bf16c"])
def test_voting_form_matches_jax(form, scene, monkeypatch):
    import jax.numpy as jnp
    import torch

    from casapose_tpu.ops.voting import ls_voting as jax_ls_voting
    from casapose_tpu_torch.ops.voting import ls_voting

    seg, dirs, conf, ref = scene
    monkeypatch.setenv("CASAPOSE_VOTING_FORM", form)
    want = np.asarray(jax_ls_voting(*(jnp.asarray(a) for a in (seg, dirs, conf)), num_points=K))
    got = ls_voting(*(torch.from_numpy(a) for a in (seg, dirs, conf)), num_points=K).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    present = np.abs(ref).sum(-1) > 0
    assert np.abs(got - ref)[present].max() < (1.0 if form == "bf16c" else 1e-3)


def test_bf16c_replaces_the_kernel_branch_and_unknown_forms_raise(scene, monkeypatch):
    import torch

    from casapose_tpu_torch.ops.plain import plain_kernels
    from casapose_tpu_torch.ops.voting import ls_voting

    seg, dirs, conf = (torch.from_numpy(a) for a in scene[:3])
    raw = torch.cat([seg, dirs, conf], dim=-1)
    monkeypatch.setenv("CASAPOSE_VOTING_FORM", "bf16c")
    alone = ls_voting(seg, dirs, conf, num_points=K)
    with plain_kernels("voting"):
        with_raw = ls_voting(seg, dirs, conf, num_points=K, raw_output=raw)
    assert torch.equal(alone, with_raw)
    monkeypatch.setenv("CASAPOSE_VOTING_FORM", "multi")
    with plain_kernels("voting"):
        kernel_branch = ls_voting(seg, dirs, conf, num_points=K, raw_output=raw)
    assert not torch.equal(alone, kernel_branch)
    monkeypatch.setenv("CASAPOSE_VOTING_FORM", "bf16")
    with pytest.raises(ValueError, match="CASAPOSE_VOTING_FORM"):
        ls_voting(seg, dirs, conf, num_points=K)


def test_bf16c_gradient_flows(scene, monkeypatch):
    """The train step's keypoint loss may take the form too (as in the JAX package): the points are differentiable
    in the directions and confidences, and the gradient is finite."""
    import torch

    from casapose_tpu_torch.ops.voting import ls_voting

    seg, dirs, conf = (torch.from_numpy(a) for a in scene[:3])
    dirs.requires_grad_(True)
    conf.requires_grad_(True)
    monkeypatch.setenv("CASAPOSE_VOTING_FORM", "bf16c")
    ls_voting(seg, dirs, conf, num_points=K).sum().backward()
    assert torch.isfinite(dirs.grad).all() and dirs.grad.abs().max() > 0 and torch.isfinite(conf.grad).all()
