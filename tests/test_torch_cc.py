"""The CC labelling kernel's sweeps (csrc/cc.cu) against casapose_tpu on the CPU.

Three labellings of the same masks must be equal exactly, with JAX's
``connected_components_labels`` and ``largest_component_mask`` as the
reference: the port's plain loop (``connected_components_plain``), and the
kernel's own sweeps compiled for the host (``csrc/cc_host.cpp``, built with
g++ as ``voting_host.cpp`` is: the kernel's 32 lanes emulated, in both of
its layouts). The cases: ``tests/test_cc_filter.py``'s LMO-like masks
(ellipses, satellites at the 50 px boundary, speckle), seeded random masks,
a serpentine that needs more than the 64-sweep cap, where all three stop
with the same labels that are not final, and lines of every length around
the kernel's lane chunks and tiles with runs on and across the lanes'
edges. The host build's sweep count per mask is held against the plain
loop's count.
"""

import ctypes
import functools
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
    lib.cc_label_host.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
    lib.cc_label_host.restype = ctypes.c_int

    def run_layout(fg, max_sweeps, shared_layout):
        m, h, w = fg.shape
        labels = np.zeros((m, h, w), np.int32)
        sweeps = np.zeros((m,), np.int32)
        assert lib.cc_label_host(fg.ctypes.data, labels.ctypes.data, sweeps.ctypes.data, m, h, w, max_sweeps,
                                 shared_layout) == 0
        return labels, sweeps

    def run(fg, max_sweeps=CAP):
        """The kernel's sweeps in its shared-memory layout, checked equal to those in its device-memory layout."""
        fg = np.ascontiguousarray(fg, dtype=np.uint8)
        labels, sweeps = run_layout(fg, max_sweeps, 1)
        labels_dev, sweeps_dev = run_layout(fg, max_sweeps, 0)
        np.testing.assert_array_equal(labels_dev, labels)
        np.testing.assert_array_equal(sweeps_dev, sweeps)
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


# Line lengths around the kernel's chunking: a lane holds chunk(n) = min(ceil(n / 32), 5) consecutive elements of a
# line (1 up to 32, 2 from 33, ...), a warp a tile of 32 * chunk(n); lines longer than 160 span tiles.
LINE_LENGTHS = (1, 31, 32, 33, 63, 64, 65, 120, 160, 161, 257, 300, 320, 481)


def _chunk(n):
    return min(-(-n // 32), 5)


def _line_pattern(n, pattern):
    """A foreground pattern along a line of n: runs on and across the lane chunks' edges."""
    i, e = np.arange(n), _chunk(n)
    if pattern == "all":
        return np.ones(n, bool)
    if pattern == "alternating":
        return i % 2 == 0
    if pattern == "gap ending each chunk":  # runs end on a lane's last element, the next starts on a lane edge
        return i % e != e - 1 if e > 1 else i % 3 != 2
    if pattern == "runs across lane edges":  # runs of chunk + 1: every run crosses a lane edge, at drifting offsets
        return i % (e + 2) != e + 1
    return np.random.default_rng(n).random(n) < 0.75


LINE_PATTERNS = ("all", "alternating", "gap ending each chunk", "runs across lane edges", "random")


def _line_masks(n, pattern):
    """Masks whose rows are lines of n with the pattern p (p, p with each gap's right neighbour filled, p: the middle
    row joins the others' runs), then the same transposed, whose columns are; for "random", two seeded random
    8 x n masks and their transposes."""
    if pattern == "random":
        rng = np.random.default_rng(n)
        masks = [rng.random((8, n)) < 0.55, rng.random((8, n)) < 0.7]
    else:
        p = _line_pattern(n, pattern)
        masks = [np.stack([p, p | np.roll(p, 1), p])]
    return [np.ascontiguousarray(m) for m in masks + [m.T for m in masks]]


@functools.lru_cache(maxsize=None)
def _line_references():
    """JAX's labels of every line mask, {(n, pattern): [(mask, labels), ...]}, from one JAX call: the masks are
    packed into one canvas with background between them, so no component leaves its mask and, as a label is a
    component's largest linear index + 1 in row-major order, each canvas label maps to the mask's own."""
    from casapose_tpu.ops.connected_components import connected_components_labels as jax_cc

    blocks = [(key, m) for key in ((n, pattern) for n in LINE_LENGTHS for pattern in LINE_PATTERNS)
              for m in _line_masks(*key)]
    width, places, x, y, shelf = 1024, [], 0, 0, 0
    for _, m in blocks:  # shelves, left to right, one free row and column after each mask
        if x + m.shape[1] > width:
            x, y, shelf = 0, y + shelf + 1, 0
        places.append((y, x))
        x, shelf = x + m.shape[1] + 1, max(shelf, m.shape[0])
    canvas = np.zeros((1, y + shelf, width), bool)
    for (_, m), (y0, x0) in zip(blocks, places):
        canvas[0, y0 : y0 + m.shape[0], x0 : x0 + m.shape[1]] = m
    ref = np.asarray(jax_cc(canvas))[0]
    out = {}
    for (key, m), (y0, x0) in zip(blocks, places):
        h, w = m.shape
        lab = ref[y0 : y0 + h, x0 : x0 + w].astype(np.int64)
        r, c = np.divmod(lab - 1, width)
        inside = (r >= y0) & (r < y0 + h) & (c >= x0) & (c < x0 + w)
        assert inside[m].all() and not lab[~m].any()
        out.setdefault(key, []).append((m, np.where(m, (r - y0) * w + (c - x0) + 1, 0).astype(np.int32)))
    return out


@pytest.mark.parametrize("n", LINE_LENGTHS)
@pytest.mark.parametrize("pattern", LINE_PATTERNS)
def test_line_lengths_exactly_equal_jax(n, pattern, host_cc):
    """Rows, then columns, of length n with the pattern: the host build's lanes, in both of the kernel's layouts,
    give JAX's labels, and the plain loop's labels and sweeps, mask by mask."""
    from casapose_tpu_torch.ops.connected_components import connected_components_plain

    for fg, ref in _line_references()[(n, pattern)]:
        host, host_sweeps = host_cc(fg[None])
        np.testing.assert_array_equal(host[0], ref)
        plain, n_sweeps = connected_components_plain(torch.from_numpy(fg[None]), return_sweeps=True)
        np.testing.assert_array_equal(plain.numpy()[0], ref)
        assert host_sweeps[0] == n_sweeps < CAP


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
