"""casapose_tpu_torch connected components and voting against casapose_tpu on the CPU.

Labels and keep-masks must be exactly equal. The voting kernel's plain
version, and the kernel's own arithmetic and summation order compiled for the
host (csrc/voting_host.cpp), are held against
``voting_accumulate_pallas(..., interpret=True)`` (rtol 2e-5, atol 2e-4, as
tests/test_voting_kernel.py:51) and ``ls_voting`` against the JAX
``ls_voting`` (rtol 1e-4, atol 5e-3 px, as :78).
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _blobs(seed, m=5, h=40, w=48):
    rng = np.random.default_rng(seed)
    fg = rng.random((m, h, w)) < 0.08
    for i in range(m):
        for _ in range(3):
            y, x = rng.integers(0, h - 8), rng.integers(0, w - 8)
            fg[i, y : y + rng.integers(2, 9), x : x + rng.integers(2, 9)] = True
    return fg


def _serpentine(h=40, w=48):
    """One long snake: 20 runs joined at alternating ends, which needs many flood sweeps."""
    fg = np.zeros((1, h, w), bool)
    for r in range(0, h, 2):
        fg[0, r, :] = True
        if r + 1 < h:
            fg[0, r + 1, (w - 1) if (r // 2) % 2 == 0 else 0] = True
    return fg


@pytest.mark.parametrize("which", ["blobs", "serpentine"])
def test_connected_component_labels_exactly_equal(which):
    import torch

    from casapose_tpu.ops.connected_components import connected_components_labels as jax_cc

    from casapose_tpu_torch.ops.connected_components import connected_components_labels

    fg = _blobs(0) if which == "blobs" else _serpentine()
    ref = np.asarray(jax_cc(fg))
    np.testing.assert_array_equal(connected_components_labels(torch.from_numpy(fg)).numpy(), ref)


@pytest.mark.parametrize("second_largest", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_largest_component_mask_exactly_equal(second_largest, weighted):
    import torch

    from casapose_tpu.ops.connected_components import largest_component_mask as jax_lcm

    from casapose_tpu_torch.ops.connected_components import largest_component_mask

    fg = _blobs(1)
    weights = np.random.default_rng(2).integers(1, 17, fg.shape).astype(np.int32) if weighted else None
    ref = np.asarray(jax_lcm(fg, min_size=12, second_largest=second_largest, weights=weights))
    got = largest_component_mask(
        torch.from_numpy(fg), min_size=12, second_largest=second_largest,
        weights=None if weights is None else torch.from_numpy(weights),
    )
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("downsample", [1, 4])
def test_instance_filter_mask_exactly_equal(downsample):
    import torch

    from casapose_tpu.ops.voting import instance_filter_mask as jax_ifm

    from casapose_tpu_torch.ops.voting import instance_filter_mask

    hot = _blobs(3, m=6, h=42, w=50).reshape(2, 3, 42, 50).transpose(0, 2, 3, 1)
    ref = np.asarray(jax_ifm(hot, 20, False, downsample=downsample))
    got = instance_filter_mask(torch.from_numpy(np.ascontiguousarray(hot)), 20, False, downsample=downsample)
    np.testing.assert_array_equal(got.numpy(), ref)


def _voting_inputs(seed=0, b=2, h=48, w=64, oc=4, k=9):
    rng = np.random.default_rng(seed)
    seg = rng.normal(0, 0.5, (b, h, w, 1 + oc)).astype(np.float32)
    seg[..., 0] += 1.0
    for o in range(oc):
        cy, cx = rng.integers(8, h - 8), rng.integers(8, w - 8)
        seg[:, cy - 6 : cy + 6, cx - 6 : cx + 6, o + 1] += 4.0
    dirs = rng.normal(size=(b, h, w, 2 * k)).astype(np.float32)
    dirs[:, :3, :5, :2] = 0.0  # zero directions take the zero guard
    conf = rng.normal(size=(b, h, w, k)).astype(np.float32)
    return seg, dirs, conf, np.concatenate([seg, dirs, conf], axis=-1)


def test_voting_plain_matches_pallas_interpret():
    import torch

    from casapose_tpu.ops.voting_kernel import voting_accumulate_pallas

    from casapose_tpu_torch.ops.voting_kernel import voting_accumulate, voting_accumulate_plain

    seg, _, _, raw = _voting_inputs()
    c = seg.shape[-1]
    labels = np.argmax(seg, axis=-1).astype(np.int32)
    ref = np.asarray(voting_accumulate_pallas(raw, labels, c, 9, interpret=True))
    got = voting_accumulate_plain(torch.from_numpy(raw), torch.from_numpy(labels), c, 9)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-4)
    # On a CPU tensor the wrapper is the plain version and launches nothing.
    voting_accumulate.launches = 0
    np.testing.assert_array_equal(voting_accumulate(torch.from_numpy(raw), torch.from_numpy(labels), c, 9).numpy(), got.numpy())
    assert voting_accumulate.launches == 0


@pytest.fixture(scope="module")
def host_voting_lib(tmp_path_factory):
    """csrc/voting_host.cpp built with g++: the CUDA kernel's features and order of sums, on the host."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    lib_path = str(tmp_path_factory.mktemp("voting_host") / "libvoting_host.so")
    src = os.path.join(ROOT, "casapose_tpu_torch", "csrc", "voting_host.cpp")
    subprocess.run([cxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-o", lib_path, src], check=True)
    lib = ctypes.CDLL(lib_path)
    lib.voting_accumulate_host.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
    lib.voting_accumulate_host.restype = ctypes.c_int
    return lib


def _host_voting_case(objects, seed=11):
    """b=2, 32x24, 9 keypoints: labels of blobs (whole segments of one class: the kernel's run path),
    background, and a band of random classes (mixed segments); raw output and labels."""
    rng = np.random.default_rng(seed)
    b, h, w, k = 2, 32, 24, 9
    seg_dim = objects + 1
    raw = rng.normal(size=(b, h, w, seg_dim + 3 * k)).astype(np.float32)
    raw[:, :2, :4, seg_dim : seg_dim + 4] = 0.0  # zero directions take the zero guard
    labels = np.zeros((b, h, w), np.int32)
    labels[:, 2:12, :] = 1
    labels[:, 12:16, 8:20] = 2
    labels[:, 16:20] = rng.integers(0, seg_dim, (b, 4, w))
    labels[1, 20:] = objects
    return raw, labels, seg_dim, k


@pytest.mark.parametrize("objects,gx", [(3, 1), (3, 2), (10, 2)])
def test_voting_kernel_math_compiled_for_the_host_matches_pallas(host_voting_lib, objects, gx):
    """The kernel's features and order of sums (csrc/voting_math.cuh, voting_host.cpp), with gx blocks per image,
    against the Pallas kernel in interpret mode: rtol 2e-5, atol 2e-4, as tests/test_voting_kernel.py:51. With
    10 objects the kernel's classes come in two groups of 8."""
    import jax.numpy as jnp

    from casapose_tpu.ops.voting_kernel import voting_accumulate_pallas

    raw, labels, seg_dim, k = _host_voting_case(objects)
    ref = np.asarray(voting_accumulate_pallas(jnp.asarray(raw), jnp.asarray(labels), seg_dim, k, interpret=True))
    b, h, w, c = raw.shape
    out = np.zeros((b, seg_dim - 1, k, 6), np.float32)
    rc = host_voting_lib.voting_accumulate_host(raw.ctypes.data, labels.ctypes.data, out.ctypes.data, b, h, w, c,
                                                seg_dim, k, gx)
    assert rc == 0
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-4)
    assert np.abs(ref[:, [0, 1, objects - 1]]).max(axis=(1, 2, 3)).min() > 1.0  # the blob classes hold pixels


@pytest.mark.parametrize("filt", [False, True])
@pytest.mark.parametrize("branch", ["einsum", "kernel_plain"])
def test_ls_voting_matches_jax(filt, branch):
    import torch

    from casapose_tpu.ops.voting import ls_voting as jax_ls_voting

    from casapose_tpu_torch.ops.plain import plain_kernels
    from casapose_tpu_torch.ops.voting import ls_voting

    seg, dirs, conf, raw = _voting_inputs(seed=3)
    ref = np.asarray(jax_ls_voting(seg, dirs, conf, num_points=9, filter_estimates=filt))
    args = [torch.from_numpy(a) for a in (seg, dirs, conf)]
    if branch == "einsum":
        got = ls_voting(*args, num_points=9, filter_estimates=filt)
    else:
        with plain_kernels("voting"):  # the kernel's branch (sums from the raw output) on the CPU
            got = ls_voting(*args, num_points=9, filter_estimates=filt, raw_output=torch.from_numpy(raw))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=5e-3)


def test_pinv_2x2_solve_rank_fallbacks_match_jax():
    import torch

    from casapose_tpu.ops.voting import _pinv_2x2_solve as jax_solve

    from casapose_tpu_torch.ops.voting import _pinv_2x2_solve

    # full rank, rank 1 (parallel directions), rank 0 (empty mask)
    a = np.array([2.0, 1.0, 0.0], np.float32)
    b = np.array([0.5, 1.0, 0.0], np.float32)
    d = np.array([1.0, 1.0, 0.0], np.float32)
    qy = np.array([0.3, 0.4, 0.0], np.float32)
    qx = np.array([0.2, 0.4, 0.0], np.float32)
    ref = [np.asarray(r) for r in jax_solve(a, b, d, qy, qx)]
    got = _pinv_2x2_solve(*(torch.from_numpy(x) for x in (a, b, d, qy, qx)))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-6, atol=1e-7)
