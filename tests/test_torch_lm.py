"""casapose_tpu_torch ``lm_refine`` against ``lm_refine_pallas`` on the CPU.

The three cases of tests/test_pnp_kernel.py, as one parametrised test, for
the kernel's plain version (``lm_refine`` on CPU tensors) and for the
kernel's own per-detection math (csrc/pnp_math.cuh) compiled for the host:

  * exact: starts perturbed by rotation noise 0.2 and t noise 0.05, no pixel
    noise, 12 iterations; the result is the planted pose at atol 1e-5 and
    err < 1e-6, as the JAX test asserts, and equals the Pallas kernel's at
    atol 1e-5;
  * noisy: 1 px of pixel noise, 15 iterations; t agrees with the Pallas
    kernel and with the XLA ``_refine`` at atol 2e-4, the JAX test's
    tolerance (the optimum is flat in t to about that);
  * stationary: started at the optimum, 5 iterations; R and t stay put at
    atol 1e-6, as the JAX test asserts.

B = 8 detections and N = 9 points, the JAX test's size; the Pallas kernel
runs once per case in interpret mode.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
from scipy.spatial.transform import Rotation

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = np.array([[572.4, 0, 325.26], [0, 573.57, 242.05], [0, 0, 1]], np.float32)

# name -> (problem arguments of _make, iterations)
CASES = {
    "exact": (dict(), 12),
    "noisy": (dict(px_noise=1.0, seed=3), 15),
    "stationary": (dict(seed=5), 5),
}


def _make(B=8, N=9, seed=0, init_rot_noise=0.2, init_t_noise=0.05, px_noise=0.0):
    """tests/test_pnp_kernel.py::_make: planted poses, their exact (or noisy) pixels and perturbed starts."""
    rng = np.random.default_rng(seed)
    pts3d = rng.uniform(-0.06, 0.06, (B, N, 3)).astype(np.float32)
    R_gt = Rotation.random(B, random_state=seed + 1).as_matrix().astype(np.float32)
    t_gt = np.stack([rng.uniform(-0.1, 0.1, B), rng.uniform(-0.1, 0.1, B), rng.uniform(0.5, 1.2, B)], 1).astype(np.float32)
    uv = (np.einsum("bij,bnj->bni", R_gt, pts3d) + t_gt[:, None]) @ K.T
    pts2d = (uv[..., :2] / uv[..., 2:]).astype(np.float32)
    if px_noise:
        pts2d = (pts2d + rng.normal(scale=px_noise, size=pts2d.shape)).astype(np.float32)
    R0 = Rotation.from_rotvec(
        Rotation.from_matrix(R_gt).as_rotvec() + rng.normal(scale=init_rot_noise, size=(B, 3))
    ).as_matrix().astype(np.float32)
    t0 = (t_gt + rng.normal(scale=init_t_noise, size=(B, 3))).astype(np.float32)
    return pts2d, pts3d, R_gt, t_gt, R0, t0


@pytest.fixture(scope="module")
def reference():
    """Per case: the problem, its start, and the Pallas kernel's result in interpret mode (and the XLA LM's t)."""
    import jax.numpy as jnp

    from casapose_tpu.ops.pnp_kernel import lm_refine_pallas
    from casapose_tpu.pose.epnp import _refine
    from casapose_tpu.pose.geometry import rotation_to_rvec

    out = {}
    for name, (kw, iterations) in CASES.items():
        pts2d, pts3d, R_gt, t_gt, R0, t0 = _make(**kw)
        if name == "stationary":
            R0, t0 = R_gt, t_gt
        Rj, tj, ej = lm_refine_pallas(
            jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(pts2d), jnp.asarray(pts3d), jnp.asarray(K),
            iterations=iterations, interpret=True,
        )
        t_xla = None
        if name == "noisy":
            p0 = jnp.concatenate([rotation_to_rvec(jnp.asarray(R0)), jnp.asarray(t0)], axis=1)
            t_xla = np.asarray(_refine(p0, jnp.asarray(pts2d), jnp.asarray(pts3d), jnp.asarray(K), iterations)[:, 3:6])
        out[name] = dict(problem=(R0, t0, pts2d, pts3d), truth=(R_gt, t_gt), iterations=iterations,
                         pallas=(np.asarray(Rj), np.asarray(tj), np.asarray(ej)), t_xla=t_xla)
    return out


def _run_plain(R0, t0, pts2d, pts3d, iterations):
    import torch

    from casapose_tpu_torch.ops.pnp_kernel import lm_refine

    lm_refine.launches = 0
    R, t, err = lm_refine(*(torch.from_numpy(np.ascontiguousarray(a)) for a in (R0, t0, pts2d, pts3d, K)),
                          iterations=iterations)
    assert lm_refine.launches == 0  # CPU tensors take the plain version, never a kernel
    return R.numpy(), t.numpy(), err.numpy()


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """csrc/pnp_host.cpp built with g++: the CUDA kernel's per-detection arithmetic, on the host."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    lib_path = str(tmp_path_factory.mktemp("lm_host") / "libpnp_host.so")
    src = os.path.join(ROOT, "casapose_tpu_torch", "csrc", "pnp_host.cpp")
    subprocess.run([cxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-o", lib_path, src], check=True)
    lib = ctypes.CDLL(lib_path)
    lib.lm_refine_host.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
    lib.lm_refine_host.restype = ctypes.c_int
    return lib


def _run_host(lib, R0, t0, pts2d, pts3d, iterations):
    B, N, _ = pts2d.shape
    ins = [np.ascontiguousarray(a, np.float32) for a in (R0, t0, pts2d, pts3d)]
    kparams = np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]], np.float32)
    R, t, err = np.zeros((B, 3, 3), np.float32), np.zeros((B, 3), np.float32), np.zeros(B, np.float32)
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    rc = lib.lm_refine_host(*(ptr(a) for a in (*ins, kparams, R, t, err)), B, N, iterations)
    assert rc == 0
    return R, t, err


@pytest.mark.parametrize("impl", ["plain", "host"])
@pytest.mark.parametrize("case", list(CASES))
def test_lm_refine_matches_pallas(reference, request, impl, case):
    ref = reference[case]
    if impl == "plain":
        R, t, err = _run_plain(*ref["problem"], ref["iterations"])
    else:
        R, t, err = _run_host(request.getfixturevalue("host_lib"), *ref["problem"], ref["iterations"])
    Rj, tj, ej = ref["pallas"]
    R_gt, t_gt = ref["truth"]
    assert np.isfinite(R).all() and np.isfinite(t).all() and np.isfinite(err).all()
    if case == "exact":
        assert err.max() < 1e-6
        np.testing.assert_allclose(t, t_gt, atol=1e-5, rtol=0)
        np.testing.assert_allclose(R, R_gt, atol=1e-5, rtol=0)
        np.testing.assert_allclose(t, tj, atol=1e-5, rtol=0)
        np.testing.assert_allclose(R, Rj, atol=1e-5, rtol=0)
    elif case == "noisy":
        np.testing.assert_allclose(t, tj, atol=2e-4, rtol=0)
        np.testing.assert_allclose(t, ref["t_xla"], atol=2e-4, rtol=0)
    else:
        np.testing.assert_allclose(t, t_gt, atol=1e-6, rtol=0)
        np.testing.assert_allclose(R, R_gt, atol=1e-6, rtol=0)
        np.testing.assert_allclose(t, tj, atol=1e-6, rtol=0)
