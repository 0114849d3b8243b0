"""The CC labelling kernel's sweeps (csrc/cc.cu) against casapose_tpu on the CPU.

Three labellings of the same masks must be equal exactly, with JAX's
``connected_components_labels`` and ``largest_component_mask`` as the
reference: the port's plain loop (``connected_components_plain``), and the
kernel's own sweeps compiled for the host (``csrc/cc_host.cpp``, built with
g++ as ``voting_host.cpp`` is). The cases: ``tests/test_cc_filter.py``'s
LMO-like masks (ellipses, satellites at the 50 px boundary, speckle),
seeded random masks, and a serpentine that needs more than the 64-sweep cap,
where all three stop with the same labels that are not final. The host
build's sweep count per mask is held against the plain loop's count.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch
from scipy import ndimage

from tests.test_cc_filter import _lmo_like_masks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAP = 64


def _serpentine(h=140, w=24):
    """One snake of h / 2 rows joined at alternating ends: a sweep floods one row further, so more than 64."""
    fg = np.zeros((1, h, w), bool)
    for r in range(0, h, 2):
        fg[0, r, :] = True
        if r + 1 < h:
            fg[0, r + 1, (w - 1) if (r // 2) % 2 == 0 else 0] = True
    return fg


def _random(seed):
    rng = np.random.default_rng(seed)
    return rng.random((6, 37, 53)) < (0.35, 0.45, 0.5, 0.55, 0.6, 0.7)[seed % 6]


def _lmo():
    hot = _lmo_like_masks()  # [2, 240, 320, 4]
    return np.ascontiguousarray(hot.transpose(0, 3, 1, 2).reshape(-1, 240, 320))


CASES = {"lmo-like": _lmo, "random 0": lambda: _random(0), "random 4": lambda: _random(4),
         "random 5": lambda: _random(5), "serpentine": _serpentine}


@pytest.fixture(scope="module")
def host_cc(tmp_path_factory):
    """csrc/cc_host.cpp built with g++: ``fg [M, h, w] -> (labels int32, sweeps per mask)`` by the kernel's sweeps."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    lib_path = str(tmp_path_factory.mktemp("cc_host") / "libcc_host.so")
    src = os.path.join(ROOT, "casapose_tpu_torch", "csrc", "cc_host.cpp")
    subprocess.run([cxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-o", lib_path, src], check=True)
    lib = ctypes.CDLL(lib_path)
    lib.cc_label_host.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
    lib.cc_label_host.restype = ctypes.c_int

    def run(fg, max_sweeps=CAP):
        fg = np.ascontiguousarray(fg, dtype=np.uint8)
        m, h, w = fg.shape
        labels = np.zeros((m, h, w), np.int32)
        sweeps = np.zeros((m,), np.int32)
        assert lib.cc_label_host(fg.ctypes.data, labels.ctypes.data, sweeps.ctypes.data, m, h, w, max_sweeps) == 0
        return labels, sweeps

    return run


@pytest.mark.parametrize("case", list(CASES))
def test_labels_exactly_equal_jax(case, host_cc):
    from casapose_tpu.ops.connected_components import connected_components_labels as jax_cc

    from casapose_tpu_torch.ops.connected_components import connected_components_plain

    fg = CASES[case]()
    ref = np.asarray(jax_cc(fg))
    plain, n_sweeps = connected_components_plain(torch.from_numpy(fg), return_sweeps=True)
    host, host_sweeps = host_cc(fg)
    assert plain.dtype == torch.int32 and ref.dtype == np.int32
    np.testing.assert_array_equal(plain.numpy(), ref)
    np.testing.assert_array_equal(host, ref)
    assert int(host_sweeps.max()) == n_sweeps  # the kernel runs each mask's sweeps; the loop runs the batch's
    if case == "serpentine":
        assert n_sweeps == CAP and host_sweeps[0] == CAP
        exact, _ = ndimage.label(fg[0])  # one component: the final label would be its largest index + 1
        assert (exact > 0).sum() == fg.sum() and exact.max() == 1
        assert len(np.unique(ref[0][fg[0]])) > 1  # at the cap the labels are not final, in JAX as here
    else:
        assert n_sweeps < CAP
        assert (host_sweeps >= 1).all()


@pytest.mark.parametrize("case", ["lmo-like", "random 5", "serpentine"])
@pytest.mark.parametrize("second_largest", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_keep_masks_exactly_equal_jax(case, second_largest, weighted, host_cc, monkeypatch):
    """``largest_component_mask`` with the host build's labels (through the ``casapose::connected_components``
    operator) and with the plain loop's, against JAX's."""
    from casapose_tpu.ops.connected_components import largest_component_mask as jax_lcm

    import casapose_tpu_torch.ops.connected_components as cc

    fg = CASES[case]()
    rng = np.random.default_rng(7)
    weights = rng.integers(0, 40, fg.shape).astype(np.int32) if weighted else None
    min_size = 30 if weighted else 50
    ref = np.asarray(jax_lcm(fg, min_size=min_size, second_largest=second_largest, weights=weights))
    tw = None if weights is None else torch.from_numpy(weights)
    plain = cc.largest_component_mask(torch.from_numpy(fg), min_size=min_size, second_largest=second_largest,
                                      weights=tw)
    np.testing.assert_array_equal(plain.numpy(), ref)

    calls = []

    def host_labels(fg_t, max_sweeps=CAP, return_sweeps=False):
        calls.append(tuple(fg_t.shape))
        return torch.from_numpy(host_cc(fg_t.numpy(), max_sweeps)[0])

    monkeypatch.setattr(cc, "connected_components_kernel", host_labels)
    got = cc.largest_component_mask(torch.from_numpy(fg), min_size=min_size, second_largest=second_largest, weights=tw)
    assert calls == [fg.shape]
    np.testing.assert_array_equal(got.numpy(), ref)


def test_wrapper_on_the_cpu_is_the_plain_loop():
    from casapose_tpu_torch.ops.connected_components import (
        connected_components_kernel,
        connected_components_labels,
        connected_components_plain,
    )
    from casapose_tpu_torch.ops.plain import plain_kernels

    fg = torch.from_numpy(_random(1))
    want, n = connected_components_plain(fg, return_sweeps=True)
    connected_components_kernel.launches = 0
    got, got_n = connected_components_kernel(fg, return_sweeps=True)
    assert torch.equal(got, want) and got_n == n
    assert torch.equal(connected_components_labels(fg), want)
    with plain_kernels("cc"):
        assert torch.equal(connected_components_labels(fg), want)
    assert connected_components_kernel.launches == 0
    # A cap of 0 sweeps leaves the first labels: each pixel's linear index + 1.
    first, zero = connected_components_plain(fg, max_sweeps=0, return_sweeps=True)
    assert zero == 0
    assert torch.equal(first.reshape(fg.shape[0], -1)[0], torch.where(
        fg[0].reshape(-1), torch.arange(1, fg[0].numel() + 1, dtype=torch.int32), torch.zeros((), dtype=torch.int32)))
