"""The port's XLA PnP path (``CASAPOSE_PNP_REFINE`` other than ``pallas``) against the JAX package's CPU path.

``casapose_tpu/pose/epnp.py::solve_pnp`` takes its XLA algorithm
(``epnp_candidates`` -> ``_refine`` from both candidates) natively on the
CPU, so the JAX side runs as it is, with no monkeypatch. Problems are planted
(exact projections of random poses, 9 points, the flagship camera) with
all-zero (degenerate) rows among them.

Tolerances, and why:
  * EPnP candidates: the smallest eigenvectors of a near-singular 12x12
    normal matrix by float32 inverse iteration; each package's candidate
    lies within ~6e-3 (R) of the planted pose and the two within 5.5e-4 of
    each other: atol 2e-3, and each candidate of ``epnp`` reprojects within
    1 px (tests/test_pnp.py's bound);
  * ``_refine`` (10 LM steps from perturbed poses) and ``solve_pnp``: atol
    1e-4 on p6d (the PnP tests' pose tolerance; measured 3e-7), the planted
    pose recovered within 1e-4, degenerate rows exactly the placeholder.
"""

import numpy as np
import pytest

from tests.torch_parity import CAMERA, planted_pnp, single_torch_thread  # noqa: F401 (autouse)

B = 64
DEGENERATE = [5, 17, 40]


@pytest.fixture(scope="module")
def problems():
    p2, p3, R, t = planted_pnp(B, seed=3)
    p2 = p2.copy()
    p2[DEGENERATE] = 0.0
    return p2, p3, R, t


def _t(*arrays):
    import torch

    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def test_epnp_candidates_match_jax(problems):
    import jax.numpy as jnp

    from casapose_tpu.pose.epnp import epnp_candidates as jax_candidates
    from casapose_tpu_torch.pose.epnp import epnp, epnp_candidates

    p2, p3, R, t = problems
    ok = np.setdiff1d(np.arange(B), DEGENERATE)
    want = jax_candidates(jnp.asarray(p2[ok]), jnp.asarray(p3[ok]), jnp.asarray(CAMERA))
    got = epnp_candidates(*_t(p2[ok], p3[ok], CAMERA))
    for (Rg, tg), (Rw, tw) in zip(got, want):
        np.testing.assert_allclose(Rg.numpy(), np.asarray(Rw), atol=2e-3, rtol=0)
        np.testing.assert_allclose(tg.numpy(), np.asarray(tw), atol=2e-3, rtol=0)
    Rb, tb = (x.numpy().astype(np.float64) for x in epnp(*_t(p2[ok], p3[ok], CAMERA)))
    uvw = (np.einsum("bij,bnj->bni", Rb, p3[ok]) + tb[:, None]) @ CAMERA.T
    err = np.linalg.norm(uvw[..., :2] / uvw[..., 2:] - p2[ok], axis=-1).mean(-1)
    assert (err < 1.0).all(), err


def test_refine_matches_jax(problems):
    import jax.numpy as jnp
    from scipy.spatial.transform import Rotation

    from casapose_tpu.pose.epnp import _refine as jax_refine
    from casapose_tpu_torch.pose.epnp import _refine

    p2, p3, R, t = problems
    ok = np.setdiff1d(np.arange(B), DEGENERATE)
    rng = np.random.default_rng(8)
    p0 = np.concatenate([Rotation.from_matrix(R[ok]).as_rotvec() + rng.normal(scale=0.05, size=(len(ok), 3)),
                         t[ok] + rng.normal(scale=0.02, size=(len(ok), 3))], 1).astype(np.float32)
    want = np.asarray(jax_refine(jnp.asarray(p0), jnp.asarray(p2[ok]), jnp.asarray(p3[ok]), jnp.asarray(CAMERA), 10))
    got = _refine(*_t(p0, p2[ok], p3[ok], CAMERA), 10).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_solve_pnp_xla_branch_matches_jax_cpu(problems, monkeypatch):
    import jax.numpy as jnp
    import torch

    import casapose_tpu_torch.pose.epnp as epnp
    from casapose_tpu.pose.epnp import solve_pnp as jax_solve_pnp
    from casapose_tpu_torch.pose.geometry import rodrigues

    p2, p3, R, t = problems
    want = np.asarray(jax_solve_pnp(jnp.asarray(p2), jnp.asarray(p3), jnp.asarray(CAMERA)))
    monkeypatch.setenv("CASAPOSE_PNP_REFINE", "xla")
    kernel_calls = []
    monkeypatch.setattr(epnp, "solve_pnp_kernel", lambda *a: kernel_calls.append(1))
    got = epnp.solve_pnp(*_t(p2, p3, CAMERA)).numpy()
    assert not kernel_calls  # the XLA branch does not reach the kernel's call site
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got[DEGENERATE], np.tile([0, 0, 0, 0, 0, 1.0], (len(DEGENERATE), 1)))
    ok = np.setdiff1d(np.arange(B), DEGENERATE)
    np.testing.assert_allclose(rodrigues(torch.from_numpy(got[ok, :3])).numpy(), R[ok], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got[ok, 3:], t[ok], atol=1e-4, rtol=0)
