"""The BPnP backward (implicit-function VJP) of the port against the JAX ``custom_vjp``, on the CPU.

* Both packages are handed the SAME solutions p6d (the CPU runs another PnP
  algorithm in each package, ROADMAP section 1 item 4), and their VJPs with
  respect to the 2D points, the 3D points and K agree to rtol 1e-4 of each
  part's max |g|; a placeholder row (rvec exactly 0, where JAX's Hessian is
  not finite) is zeroed in both.
* Through ``bpnp_pose`` under autograd the gradients are the VJP's, K's
  summed over the batch.

The train step's gradient through BPnP: tests/test_torch_train_bpnp_step.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_parity import CAMERA, planted_pnp
from tests.torch_parity import single_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def solved():
    """8 noisy planted problems, one all-zero row, their port solutions and an upstream gradient."""
    from casapose_tpu_torch.pose.epnp import solve_pnp

    p2, p3, _, _ = planted_pnp(8, seed=3)
    rng = np.random.default_rng(4)
    p2 = (p2 + rng.normal(0.0, 0.5, p2.shape)).astype(np.float32)
    p2[-1] = 0.0  # the placeholder pose, rvec = 0
    p6d = solve_pnp(*(torch.from_numpy(a) for a in (p2, p3, CAMERA))).numpy()
    g = rng.normal(size=(8, 6)).astype(np.float32)
    return p2, p3, p6d, g


def test_vjp_matches_jax_on_the_same_solutions(solved):
    from casapose_tpu.pose.bpnp import _bpnp_bwd
    from casapose_tpu_torch.pose.bpnp import ift_vjp

    p2, p3, p6d, g = solved
    assert np.array_equal(p6d[-1], [0, 0, 0, 0, 0, 1])
    jd = [np.asarray(x) for x in jax.jit(_bpnp_bwd)(tuple(jnp.asarray(a) for a in (p6d, p2, p3, CAMERA)), jnp.asarray(g))]
    dx, dz, dK = ift_vjp(*(torch.from_numpy(a) for a in (g, p6d, p2, p3, CAMERA)))
    for port, ref in zip((dx.numpy(), dz.numpy(), dK.sum(0).numpy()), jd):
        assert np.abs(ref).max() > 0
        np.testing.assert_allclose(port, ref, rtol=0, atol=1e-4 * np.abs(ref).max())
    assert not dx[-1].any() and not dz[-1].any() and not dK[-1].any() and not jd[0][-1].any()


def test_bpnp_pose_backward_is_the_vjp(solved):
    from casapose_tpu_torch.pose.bpnp import bpnp_pose, ift_vjp

    p2, p3, p6d, g = solved
    x, z, K = (torch.tensor(a, requires_grad=True) for a in (p2, p3, CAMERA))
    out = bpnp_pose(x, z, K)
    np.testing.assert_array_equal(out.detach().numpy(), p6d)
    out.backward(torch.from_numpy(g))
    dx, dz, dK = ift_vjp(*(torch.from_numpy(a) for a in (g, p6d, p2, p3, CAMERA)))
    torch.testing.assert_close(x.grad, dx, rtol=0, atol=0)
    torch.testing.assert_close(z.grad, dz, rtol=0, atol=0)
    torch.testing.assert_close(K.grad, dK.sum(0), rtol=0, atol=0)
