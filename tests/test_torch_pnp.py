"""casapose_tpu_torch PnP against casapose_tpu on the CPU.

The PnP kernel's plain version is held against
``solve_pnp_pallas(..., interpret=True)`` on planted poses (t atol 2e-4, as
tests/test_pnp_kernel.py:58; R atol 1e-4), and so is the kernel's own
per-detection math (csrc/pnp_math.cuh) compiled for the host. ``poses_pnp``
is held against the JAX ``poses_pnp``, which on the CPU solves with the XLA
algorithm: on planted poses both reach the exact pose.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest

from tests.torch_parity import CAMERA, planted_pnp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def planted():
    """Six planted poses and two rows of random points, through the Pallas kernel in interpret mode (once)."""
    import jax.numpy as jnp

    from casapose_tpu.ops.pnp_kernel import solve_pnp_pallas

    p2, p3, R, t = planted_pnp(6, seed=0)
    rng = np.random.default_rng(9)
    p2 = np.concatenate([p2, rng.uniform(0, 48, (2, 9, 2)).astype(np.float32)])
    p3 = np.concatenate([p3, rng.uniform(-0.05, 0.05, (2, 9, 3)).astype(np.float32)])
    Rj, tj, ej = solve_pnp_pallas(jnp.asarray(p2), jnp.asarray(p3), jnp.asarray(CAMERA), interpret=True)
    return p2, p3, R, t, np.asarray(Rj), np.asarray(tj), np.asarray(ej)


def test_plain_pnp_matches_pallas_interpret_on_planted_poses(planted):
    import torch

    from casapose_tpu_torch.ops.pnp_kernel import solve_pnp_plain

    p2, p3, R, t, Rj, tj, ej = planted
    Rp, tp, ep = solve_pnp_plain(torch.from_numpy(p2), torch.from_numpy(p3), torch.from_numpy(CAMERA))
    np.testing.assert_allclose(tp.numpy()[:6], tj[:6], atol=2e-4, rtol=0)
    np.testing.assert_allclose(Rp.numpy()[:6], Rj[:6], atol=1e-4, rtol=0)
    np.testing.assert_allclose(tp.numpy()[:6], t, atol=2e-4, rtol=0)
    assert np.isfinite(Rp.numpy()).all() and np.isfinite(tp.numpy()).all()
    # Random rows are ill-posed; both solvers must end at the same residual to 1e-3 relative.
    np.testing.assert_allclose(ep.numpy()[6:], ej[6:], rtol=1e-3)


def test_kernel_wrapper_on_cpu_is_the_plain_version(planted):
    import torch

    from casapose_tpu_torch.ops.pnp_kernel import solve_pnp_kernel, solve_pnp_plain

    p2, p3 = (torch.from_numpy(a) for a in planted[:2])
    solve_pnp_kernel.launches = 0
    got = solve_pnp_kernel(p2, p3, torch.from_numpy(CAMERA))
    want = solve_pnp_plain(p2, p3, torch.from_numpy(CAMERA))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert solve_pnp_kernel.launches == 0


@pytest.mark.parametrize("kernel", ["voting", "pnp"])
def test_plain_kernels_routes_only_the_named_call_site(kernel, planted, monkeypatch):
    """Inside ``plain_kernels(name)`` the call site of ``name`` calls its plain version instead of its kernel
    wrapper (voting: on the kernel's branch, from the raw output), the other call site is unchanged; on leaving,
    both are as before. An unknown name raises."""
    import torch

    import casapose_tpu_torch.ops.voting as voting
    import casapose_tpu_torch.pose.epnp as epnp
    from casapose_tpu_torch.ops.plain import is_plain, plain_kernels

    called = []

    def wrapper(name, fn):
        return lambda *a, **k: called.append(name) or fn(*a, **k)

    monkeypatch.setattr(epnp, "solve_pnp_kernel", wrapper("pnp", epnp.solve_pnp_kernel))
    monkeypatch.setattr(epnp, "solve_pnp_plain", wrapper("pnp plain", epnp.solve_pnp_plain))
    monkeypatch.setattr(voting, "voting_accumulate", wrapper("voting", voting.voting_accumulate))
    monkeypatch.setattr(voting, "voting_accumulate_plain", wrapper("voting plain", voting.voting_accumulate_plain))
    p2, p3 = (torch.from_numpy(a) for a in planted[:2])
    K = torch.from_numpy(CAMERA)
    rng = np.random.default_rng(2)
    raw = torch.from_numpy(rng.normal(size=(1, 16, 20, 3 + 27)).astype(np.float32))

    def run():
        called.clear()
        epnp.solve_pnp(p2, p3, K)
        voting.ls_voting(raw[..., :3], raw[..., 3:21], raw[..., 21:], num_points=9, raw_output=raw)
        return list(called)

    assert run() == ["pnp"]  # a CPU tensor: the voting call site takes the einsum branch, not the kernel's
    with plain_kernels(kernel):
        assert is_plain(kernel) and not is_plain({"voting": "pnp", "pnp": "voting"}[kernel])
        assert run() == (["pnp plain"] if kernel == "pnp" else ["pnp", "voting plain"])
    assert not is_plain(kernel) and run() == ["pnp"]
    with pytest.raises(ValueError):
        with plain_kernels("lm_refine"):
            pass


def test_kernel_math_compiled_for_the_host_matches_pallas(planted, tmp_path_factory):
    """csrc/pnp_math.cuh is __host__ __device__: the host build checks the CUDA kernel's arithmetic here."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    lib_path = str(tmp_path_factory.mktemp("pnp_host") / "libpnp_host.so")
    src = os.path.join(ROOT, "casapose_tpu_torch", "csrc", "pnp_host.cpp")
    subprocess.run([cxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-o", lib_path, src], check=True)
    lib = ctypes.CDLL(lib_path)
    lib.solve_pnp_host.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
    lib.solve_pnp_host.restype = ctypes.c_int
    p2, p3, R, t, Rj, tj, ej = planted
    B = p2.shape[0]
    Rh, th, eh = np.zeros((B, 3, 3), np.float32), np.zeros((B, 3), np.float32), np.zeros(B, np.float32)
    kp = np.ascontiguousarray(CAMERA, np.float32)  # [3, 3]: the kernel reads fx, fy, cx, cy from K itself
    p2c, p3c = np.ascontiguousarray(p2), np.ascontiguousarray(p3)
    rc = lib.solve_pnp_host(*(a.ctypes.data for a in (p2c, p3c, kp, Rh, th, eh)), B, 9, 10)
    assert rc == 0
    np.testing.assert_allclose(th[:6], tj[:6], atol=2e-4, rtol=0)
    np.testing.assert_allclose(Rh[:6], Rj[:6], atol=1e-4, rtol=0)
    np.testing.assert_allclose(eh[6:], ej[6:], rtol=1e-3)


def test_degenerate_rows_give_the_placeholder_pose():
    import torch

    from casapose_tpu_torch.pose.epnp import pose_matrix_from_p6d, solve_pnp

    p2, p3, _, t = planted_pnp(4, seed=2)
    p2[1] = 0.0
    p2[3] = 1e-6
    p6d = solve_pnp(torch.from_numpy(p2), torch.from_numpy(p3), torch.from_numpy(CAMERA))
    placeholder = torch.tensor([0.0, 0.0, 0.0, 0.0, 0.0, 1.0])
    assert torch.equal(p6d[1], placeholder) and torch.equal(p6d[3], placeholder)
    np.testing.assert_allclose(p6d[[0, 2], 3:].numpy(), t[[0, 2]], atol=2e-4, rtol=0)
    RT = pose_matrix_from_p6d(p6d)
    assert torch.equal(RT[1], torch.cat([torch.eye(3), torch.tensor([[0.0], [0.0], [1.0]])], dim=1))


def test_rotation_helpers_match_jax():
    import torch
    from scipy.spatial.transform import Rotation

    from casapose_tpu.pose.geometry import rodrigues as jax_rodrigues
    from casapose_tpu.pose.geometry import rotation_to_rvec as jax_rotation_to_rvec

    from casapose_tpu_torch.pose.geometry import rodrigues, rotation_to_rvec

    rng = np.random.default_rng(4)
    rvecs = Rotation.random(6, random_state=5).as_rotvec().astype(np.float32)
    rvecs[0] = 0.0  # identity
    rvecs[1] = [1e-7, 0.0, 0.0]  # theta ~ 0
    rvecs[2] = np.array([0.0, np.pi - 1e-4, 0.0], np.float32)  # theta ~ pi
    rvecs[3] = rng.normal(size=3).astype(np.float32)
    R = rodrigues(torch.from_numpy(rvecs))
    np.testing.assert_allclose(R.numpy(), np.asarray(jax_rodrigues(rvecs)), atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        rotation_to_rvec(R).numpy(), np.asarray(jax_rotation_to_rvec(np.asarray(jax_rodrigues(rvecs)))), atol=1e-5, rtol=0
    )


def test_poses_pnp_matches_jax():
    import jax.numpy as jnp
    import torch

    from casapose_tpu.pose.evaluation import poses_pnp as jax_poses_pnp

    from casapose_tpu_torch.pose.evaluation import poses_pnp

    b, oc, k, h, w = 2, 3, 9, 24, 32
    p2, p3, _, _ = planted_pnp(b * oc, seed=7)
    coords = p2[..., ::-1].reshape(b, oc, k, 2).copy()  # (x, y) -> the voting's (y, x)
    coords[1, 0] = 0.0  # a missing object: the placeholder pose
    kp3 = p3.reshape(b, oc, 1, k, 3)
    seg = np.zeros((b, h, w, 1 + oc), np.float32)
    seg[..., 0] = 1.0
    seg[:, :10, :10, 1] = 2.0  # 100 px: available
    seg[0, 12:16, 12:17, 2] = 2.0  # 20 px: not above min_num, masked
    seg[1, 12:20, 12:20, 2] = 2.0
    seg[:, 18:, 20:, 3] = 2.0
    cam = np.broadcast_to(CAMERA, (b, 3, 3)).copy()
    ref = np.asarray(jax_poses_pnp(jnp.asarray(coords), jnp.asarray(seg), jnp.asarray(kp3), jnp.asarray(cam), oc))
    got = poses_pnp(*(torch.from_numpy(np.ascontiguousarray(a)) for a in (coords, seg, kp3, cam)), oc).numpy()
    assert got.shape == (b, oc, 1, 3, 4)
    np.testing.assert_array_equal(got[0, 1], 0.0)
    np.testing.assert_array_equal(got[1, 0, 0], np.concatenate([np.eye(3), [[0.0], [0.0], [1.0]]], axis=1))
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=0)
