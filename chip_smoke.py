#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (casapose_tpu_torch) on one CUDA card.

    python3 chip_smoke.py            # from the repository root; needs one card

Phases, one line each with its seconds:
  1. device: nvidia-smi name and power limit, torch and CUDA versions;
  2. build: every kernel in casapose_tpu_torch/csrc, one nvcc per source,
     all started together, with ptxas's register / spill report;
  3. pnp: the PnP kernel against its plain version at B=256, N=9 on planted
     poses and random rows, the same bits on a second run, all-zero rows
     through solve_pnp, and planted poses at the eval path's B = 8 and 64,
     each with its kernel_ms and call_ms (below);
  4. voting: the voting kernel against its plain version run in float64 at
     b=1 and b=32, 480x640, C=36, and the same bits on a second run (also
     at b=2 with 13 objects, C=41, and with 12 keypoints); at
     b=32 its kernel_ms on these random dense labels (every segment of 32
     pixels mixes classes: the kernel's slowest case);
  5. step: the flagship inference step (casapose_c_gcu5 -> CC-filtered LS
     voting -> EPnP+LM) at 480x640, 8 objects, 9 keypoints, float32 with
     TF32 off, random weights from a seed, at batch 1 and 32 on a zero and a
     noise image; every kernel must launch, every pose must be finite, and
     the voted points must agree with the same step run through the
     kernels' plain versions on the card; how the two steps' poses
     reproject is reported (random weights make the PnP problems
     ill-posed; phases 3 and 8 hold the poses elementwise on planted
     problems);
  6. timings with CUDA events: ms/image of the step and of its stages, each
     kernel, its plain version and, where one exists, a PyTorch yardstick
     (library_ms). A kernel's own device time, kernel_ms, is taken from 20
     wrapper calls captured in a CUDA graph and replayed between CUDA events
     (the wrapper's host checks, allocations and ctypes call drop out; if
     capture fails, from torch.profiler's kernel times instead, and the JSON
     line says which); call_ms is 20 eager calls between events, what a step
     pays per call;
  7. lm: the LM kernel (lm_refine) driven as its one caller drives it (refine
     perturbed starts, at B=256, N=9, 10 and 12 iterations), then held
     against its plain version: max |dR|, |dt|, err < 1e-6 without noise,
     the same bits on a second run;
  8. eval: the flagship evaluation step (casapose_c_gcu5 -> CC-filtered LS
     voting -> keypoint loss with EPnP+LM -> ADD(-S)/2D metrics -> losses)
     at 480x640, 8 objects, 9 keypoints, float32 with TF32 off, random
     weights from a seed, at batch 1 and at batch 32 with eval_chunk 8, on a
     seeded batch in the loader's format whose eval meshes include 7862- and
     3417-vertex objects (ADD-S at full size); every kernel must launch,
     every output must be finite, and against the same step through the
     kernels' plain versions on the card the voted points agree within
     5e-3 px, the losses within rtol 1e-4 and the gt / missing / false
     positive counts exactly. The batch's PnP problems are well-posed: its
     model keypoints are put where planted poses project them exactly onto
     the points the step votes, through the batch's camera. Each PnP kernel
     launch of the step is recorded with its inputs (B = 8 at batch 1, 64
     per chunk) and held against the plain version on them (atol R 1e-4, t
     2e-4), and every present object's solve against its planted pose; the
     error sums are reported;
  9. metrics: evaluate_poses on planted poses at M = 256, V = 7862 against a
     float64 numpy oracle (scipy's KD-tree for ADD-S): per-object sums, and
     ADD-S per row with every row symmetric;
 10. eval timings with CUDA events: the step's ms/image at batch 1 and 32
     (eval_chunk 8) and its stages, and the LM kernel's kernel_ms and
     call_ms, its plain version and its bound;
 11. harness: `python -m casapose_tpu_torch.eval` on a 480x640, 8-object
     synthetic NDDS scene written to a temporary directory, at
     --batchsize_test 32 --eval_chunk 8.
Then a "kernels" JSON line, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Any failed phase raises and the script exits non-zero. Without a CUDA
device, or without the package beside it, it exits non-zero and prints no
result.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet: HBM3 rate and float32 rate outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

H, W, OBJECTS, K_POINTS = 480, 640, 8, 9
SEG_DIM = 1 + OBJECTS
CHANNELS = SEG_DIM + 3 * K_POINTS
CAMERA = [[572.4, 0.0, 325.3], [0.0, 573.5, 242.0], [0.0, 0.0, 1.0]]


def say(phase, t0, msg):
    print(f"[{phase}] {time.time() - t0:.2f}s {msg}", flush=True)


def cuda_ms(fn, iters, warmup=1):
    """Mean milliseconds of ``fn()`` over ``iters`` calls, between CUDA events after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


KERNEL_MS_METHOD = {}  # kernel name -> "cuda graph" or "profiler", the method kernel_ms used


def kernel_ms(name, fn, iters=20, reps=5):
    """Device milliseconds of one ``fn()`` (a kernel wrapper call) without its host work.

    ``iters`` calls are captured in a CUDA graph, and the graph is replayed
    ``reps`` times between CUDA events: only the device work is replayed, so
    the wrapper's checks, allocations and ctypes call drop out. If capture
    fails, the kernels' own device time is summed from torch.profiler's
    ``key_averages()`` instead. The method used is kept in KERNEL_MS_METHOD.
    """
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    try:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn()
    except RuntimeError as e:  # capture refused: time the kernels from a trace instead
        print(f"  kernel_ms {name}: graph capture failed ({e}); using torch.profiler", flush=True)
        KERNEL_MS_METHOD[name] = "profiler"
        return profiler_kernel_ms(fn, iters)
    KERNEL_MS_METHOD[name] = "cuda graph"
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (iters * reps)


def profiler_kernel_ms(fn, iters):
    """Device milliseconds per ``fn()`` of the CUDA kernels it launches, from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))
                   for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA)
    return total_us / 1e3 / iters


def random_rotations(rng, n):
    q = rng.normal(size=(n, 4))
    return quaternion_rotations(q / np.linalg.norm(q, axis=1, keepdims=True))


def pnp_problems(B, n_random, seed=0):
    """pts2d [B, 9, 2], pts3d [B, 9, 3], K: planted poses first, then ``n_random`` random rows."""
    rng = np.random.default_rng(seed)
    K = np.array(CAMERA, np.float64)
    pts3d = rng.uniform(-0.06, 0.06, (B, K_POINTS, 3))
    R = random_rotations(rng, B)
    t = np.stack([rng.uniform(-0.1, 0.1, B), rng.uniform(-0.1, 0.1, B), rng.uniform(0.5, 1.2, B)], 1)
    uvw = (np.einsum("bij,bnj->bni", R, pts3d) + t[:, None]) @ K.T
    pts2d = uvw[..., :2] / uvw[..., 2:]
    pts2d[B - n_random :] = rng.uniform(0, H, (n_random, K_POINTS, 2))
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    return f32(pts2d), f32(pts3d), f32(K), f32(R), f32(t)


def voting_inputs(b, seed, seg_dim=SEG_DIM, k=K_POINTS):
    """Raw output [b, H, W, seg_dim + 3k] (normal noise, one planted blob whose directions point at a keypoint)
    and random labels [b, H, W] in 0..seg_dim-1 with the blob labelled 1."""
    rng = np.random.default_rng(seed)
    raw = rng.normal(size=(b, H, W, seg_dim + 3 * k)).astype(np.float32)
    labels = rng.integers(0, seg_dim, (b, H, W)).astype(np.int32)
    y0, x0 = 200, 300
    yy, xx = np.mgrid[y0 : y0 + 64, x0 : x0 + 96]
    for j in range(k):
        ky, kx = rng.uniform(0, H), rng.uniform(0, W)
        raw[:, y0 : y0 + 64, x0 : x0 + 96, seg_dim + 2 * j] = ky - yy
        raw[:, y0 : y0 + 64, x0 : x0 + 96, seg_dim + 2 * j + 1] = kx - xx
    labels[:, y0 : y0 + 64, x0 : x0 + 96] = 1
    return raw, labels


def check_voting(raw, lab, seg_dim, k):
    """The voting kernel twice and its plain version in float32 and float64 on (raw, lab): raises unless the
    kernel is within the float64 tolerance and repeats its bits. Returns (S kernel, S plain, err, plain err,
    allowed)."""
    import torch

    from casapose_tpu_torch.ops.voting_kernel import voting_accumulate, voting_accumulate_plain

    S1 = voting_accumulate(raw, lab, seg_dim, k)
    S2 = voting_accumulate(raw, lab, seg_dim, k)
    Sp = voting_accumulate_plain(raw, lab, seg_dim, k)
    S64 = voting_accumulate_plain(raw.double(), lab, seg_dim, k)
    torch.cuda.synchronize()
    # Held against the plain version in float64, as tests/test_voting_kernel.py:51 holds the Pallas
    # kernel against a float64 oracle: atol 2e-4 plus rtol 2e-5 of the sum of |terms|. A class here
    # sums ~34,000 terms whose signed features cancel, so float32 rounding in ANY order is ~1e-7 of
    # that absolute sum, not of |S|. |a|, |b|, |d| <= w and |qy|, |qx| <= w (1 + W/H) bound it by the
    # weight mass S[..., 5].
    scale = torch.tensor([1.0, 1.0, 1.0, 1 + W / H, 1 + W / H, 1.0], device=raw.device, dtype=torch.float64)
    allowed = 2e-4 + 2e-5 * S64[..., 5:6] * scale
    err = (S1.double() - S64).abs()
    plain_err = (Sp.double() - S64).abs()
    if not (err <= allowed).all():
        raise AssertionError(f"voting kernel disagrees with float64 (seg_dim {seg_dim}, k {k}): worst |dS| / allowed "
                             f"{(err / allowed).max().item()}")
    if not torch.equal(S1, S2):
        raise AssertionError("voting kernel: two runs differ in their bits")
    return S1, Sp, err, plain_err, allowed


def reprojection_sq(poses, coords, keypoints3d, camera):
    """Sum over keypoints of squared pixel residuals of poses [b, oc, 1, 3, 4] on voted (y, x) points."""
    import torch

    Rt = poses.reshape(-1, 3, 4)
    X = keypoints3d.reshape(-1, K_POINTS, 3)
    cam = X @ Rt[:, :, :3].transpose(1, 2) + Rt[:, None, :, 3]
    K = camera[0]
    z = torch.where(cam[..., 2].abs() < 1e-9, torch.full_like(cam[..., 2], 1e-9), cam[..., 2])
    u = K[0, 0] * cam[..., 0] / z + K[0, 2]
    v = K[1, 1] * cam[..., 1] / z + K[1, 2]
    pts = coords.reshape(-1, K_POINTS, 2)
    return ((u - pts[..., 1]) ** 2 + (v - pts[..., 0]) ** 2).sum(dim=1)


def consistent_keypoints(coords, b, seed=5):
    """Model keypoints [b, oc, 1, k, 3] that random poses project exactly onto the voted (y, x) points
    ``coords`` [b, oc, k, 2] through a short-focal camera (f = 16 px), and that camera [b, 3, 3]."""
    import torch

    rng = np.random.default_rng(seed)
    n = b * OBJECTS
    K = np.array([[16.0, 0.0, W / 2], [0.0, 16.0, H / 2], [0.0, 0.0, 1.0]])
    R = random_rotations(rng, n)
    t = np.stack([rng.uniform(-0.05, 0.05, n), rng.uniform(-0.05, 0.05, n), rng.uniform(0.75, 0.85, n)], 1)
    pts = coords.reshape(n, K_POINTS, 2).flip(-1).double().cpu().numpy()
    rays = np.concatenate([pts, np.ones((n, K_POINTS, 1))], axis=-1) @ np.linalg.inv(K).T
    cam_pts = rays * rng.uniform(0.75, 0.85, (n, K_POINTS, 1))
    model = np.einsum("bji,bnj->bni", R, cam_pts - t[:, None]).reshape(b, OBJECTS, 1, K_POINTS, 3)
    dev = coords.device
    camera = torch.tensor(K, dtype=torch.float32, device=dev).expand(b, 3, 3).contiguous()
    return torch.tensor(model, dtype=torch.float32, device=dev), camera


def pnp_flops(n_points, iterations):
    """Operations of one PnP solve, counted from the algorithm's loops (casapose_tpu_torch/csrc/pnp_math.cuh).

    EPnP: means, barycentrics and the 10 x 4 closed-form sums (~108 N),
    the 12x12 Cholesky (~576), 6 x 2 triangular solve pairs with
    normalisation (~4080), the Rayleigh-Ritz matvecs (~1250), two pose
    fits (~1500 + 57 N each) and the beta-2 system (~220); LM: 2 candidates x
    ``iterations`` x (~168 N + 230).
    """
    n = n_points
    return 108 * n + 576 + 4080 + 1250 + 2 * (1500 + 57 * n) + 220 + 2 * iterations * (168 * n + 230)

EVAL_CHUNK = 8
# Eval mesh sizes: the first two are the symmetric rule's vertex counts (ADD-S), padded to 7862.
VERTEX_COUNTS = (7862, 3417, 500, 1000, 1500, 2000, 2500, 3000)


def lm_flops(n_points, iterations):
    """Operations of one LM refinement: the LM term of :func:`pnp_flops` for one candidate."""
    return iterations * (168 * n_points + 230)


def lm_problems(B, seed, rot_noise=0.2, t_noise=0.05):
    """tests/test_pnp_kernel.py::_make at B detections: planted poses, exact pixels, perturbed starts."""
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(seed)
    K = np.array(CAMERA)
    pts3d = rng.uniform(-0.06, 0.06, (B, K_POINTS, 3))
    R = random_rotations(rng, B)
    t = np.stack([rng.uniform(-0.1, 0.1, B), rng.uniform(-0.1, 0.1, B), rng.uniform(0.5, 1.2, B)], 1)
    uvw = (np.einsum("bij,bnj->bni", R, pts3d) + t[:, None]) @ K.T
    pts2d = uvw[..., :2] / uvw[..., 2:]
    R0 = Rotation.from_rotvec(Rotation.from_matrix(R).as_rotvec() + rng.normal(scale=rot_noise, size=(B, 3))).as_matrix()
    t0 = t + rng.normal(scale=t_noise, size=(B, 3))
    f32 = lambda a: np.ascontiguousarray(a, np.float32)  # noqa: E731
    return f32(R0), f32(t0), f32(pts2d), f32(pts3d), f32(K), f32(R), f32(t)


def quaternion_rotations(q):
    """Unit quaternions [n, 4] (w, x, y, z) -> rotation matrices [n, 3, 3]."""
    w, x, y, z = q.T
    return np.stack(
        [
            np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
            np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
            np.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
        ],
        axis=1,
    )


def eval_meshes(seed=0):
    """Eval vertex clouds [8, 7862, 3] (zero-padded) and counts [8, 1]."""
    rng = np.random.default_rng(seed)
    verts = np.zeros((OBJECTS, max(VERTEX_COUNTS), 3), np.float32)
    for o, n in enumerate(VERTEX_COUNTS):
        verts[o, :n] = rng.uniform(-0.05, 0.05, (n, 3))
    return verts, np.array(VERTEX_COUNTS, np.int32)[:, None]


def eval_batch(b, seed):
    """A batch in the format the harness's loader emits, from planted poses.

    uint8 images; label maps with the 8 objects as H/4 x W/8 blocks on a
    2 x 4 grid, object i % 8 absent from image i; keypoints2d (y, x) and
    poses_gt from planted poses; absent objects as the loader writes them
    (keypoints2d -1000, zero pose, diameter -1); identity offsets.
    """
    rng = np.random.default_rng(seed)
    K = np.array(CAMERA)
    kp3 = rng.uniform(-0.05, 0.05, (OBJECTS, K_POINTS, 3))
    img = rng.integers(0, 256, (b, H, W, 3)).astype(np.uint8)
    seg = np.zeros((b, H, W, 1), np.uint8)
    kp2d = np.full((b, OBJECTS, 1, K_POINTS, 2), -1000.0)
    poses = np.zeros((b, OBJECTS, 1, 3, 4))
    diam = np.full((b, OBJECTS, 1, 1), -1.0)
    R = random_rotations(rng, b * OBJECTS).reshape(b, OBJECTS, 3, 3)
    for i in range(b):
        for o in range(OBJECTS):
            if o == i % OBJECTS:
                continue
            cy, cx = H // 4 + H // 2 * (o // 4), W // 8 + W // 4 * (o % 4)
            z = rng.uniform(0.7, 0.9)
            t = np.array([(cx - K[0, 2]) / K[0, 0] * z, (cy - K[1, 2]) / K[1, 1] * z, z])
            poses[i, o, 0] = np.concatenate([R[i, o], t[:, None]], 1)
            uvw = (kp3[o] @ R[i, o].T + t) @ K.T
            kp2d[i, o, 0] = (uvw[:, :2] / uvw[:, 2:])[:, ::-1]
            seg[i, cy - H // 8 : cy + H // 8, cx - W // 16 : cx + W // 16] = o + 1
            diam[i, o] = 0.1
    f32 = lambda a: np.ascontiguousarray(a, np.float32)  # noqa: E731
    return {
        "img": img, "seg": seg, "keypoints2d": f32(kp2d),
        "keypoints3d": f32(np.broadcast_to(kp3[None, :, None], (b, OBJECTS, 1, K_POINTS, 3))),
        "camera": f32(np.broadcast_to(K, (b, 3, 3))), "diameters": f32(diam),
        "offsets": f32(np.array([[0, 0, H, W, 0, 0, 0, 1.0, W, H]] * b)), "poses_gt": f32(poses),
    }


def planted_eval_batch(model, opt, b, seed, dev):
    """:func:`eval_batch` with well-posed PnP problems for the step's own voted points, as tensors on ``dev``.

    The step votes on the GT segmentation (train_vectors_with_ground_truth),
    so its voted points depend only on it and the network's direction
    channels: vote here, one chunk at a time as the step does, then put each
    present object's model keypoints where a planted pose projects them
    exactly onto its voted points through the batch's camera (depths 0.75 to
    0.85 m). poses_gt is the planted pose moved by (6, -4, 8) cm, so that
    the keypoint loss is not ~0, and keypoints2d its projections, as the
    loader writes them. Absent objects stay as the loader writes them.
    Returns (batch, planted poses [b, oc, 3, 4], zero where absent).
    """
    import torch

    from casapose_tpu_torch.core.numerics import f32_precision
    from casapose_tpu_torch.data.pipeline import prepare_device_batch
    from casapose_tpu_torch.ops.voting import ls_voting

    batch = eval_batch(b, seed)
    coords = []
    with torch.no_grad(), f32_precision():
        for i in range(0, b, EVAL_CHUNK):
            img, tseg = prepare_device_batch(*(torch.from_numpy(batch[k][i : i + EVAL_CHUNK]).to(dev) for k in ("img", "seg")),
                                             SEG_DIM, grayscale_to_rgb=not opt.color_dataset)
            out = model(img, tseg)
            coords.append(ls_voting(
                tseg, out[..., SEG_DIM : SEG_DIM + 2 * K_POINTS], out[..., SEG_DIM + 2 * K_POINTS :], num_points=K_POINTS,
                filter_estimates=bool(opt.confidence_filter_estimates),
                output_second_largest_component=bool(opt.confidence_choose_second),
                cc_downsample=int(opt.cc_filter_downsample), raw_output=out).double().cpu().numpy())
    pts = np.concatenate(coords).reshape(-1, K_POINTS, 2)  # (y, x)
    rng = np.random.default_rng(5)
    n = b * OBJECTS
    K = np.array(CAMERA)
    R = random_rotations(rng, n)
    t = np.stack([rng.uniform(-0.05, 0.05, n), rng.uniform(-0.05, 0.05, n), rng.uniform(0.75, 0.85, n)], 1)
    xy1 = np.concatenate([pts[..., ::-1], np.ones((n, K_POINTS, 1))], axis=-1)
    cam_pts = (xy1 @ np.linalg.inv(K).T) * rng.uniform(0.75, 0.85, (n, K_POINTS, 1))
    model_pts = np.einsum("bji,bnj->bni", R, cam_pts - t[:, None]).reshape(b, OBJECTS, 1, K_POINTS, 3)
    present = (batch["diameters"][..., 0] > 0)[..., None, None]  # [b, oc, 1, 1, 1]
    planted = np.concatenate([R, t[:, :, None]], -1).reshape(b, OBJECTS, 3, 4)
    t_gt = t + [0.06, -0.04, 0.08]
    uvw = (np.einsum("nij,nkj->nki", R, model_pts.reshape(n, K_POINTS, 3)) + t_gt[:, None]) @ K.T
    kp2d = (uvw[..., :2] / uvw[..., 2:])[..., ::-1].reshape(b, OBJECTS, 1, K_POINTS, 2)
    poses_gt = np.concatenate([R, t_gt[:, :, None]], -1).reshape(b, OBJECTS, 1, 3, 4)
    batch["keypoints3d"] = np.where(present, model_pts, batch["keypoints3d"]).astype(np.float32)
    batch["poses_gt"] = np.where(present, poses_gt, 0.0).astype(np.float32)
    batch["keypoints2d"] = np.where(present, kp2d, -1000.0).astype(np.float32)
    planted = np.where(present[:, :, 0], planted, 0.0).astype(np.float32)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in batch.items()}, torch.from_numpy(planted).to(dev)


def eval_opt(chunk):
    """The flagship evaluation config (configs/config_8.ini) with --eval_chunk."""
    from casapose_tpu_torch.utils.config import parse_config

    return parse_config(["-c", os.path.join(ROOT, "configs", "config_8.ini"), "--objects_to_copy_list", "",
                         "--eval_chunk", str(chunk), "--outf", "chip_smoke/unused"])


def evaluate_poses_oracle(poses, poses_gt, pts, counts, cams, diam, filt):
    """evaluate_poses in float64 numpy, ADD-S by scipy's KD-tree: the 7 per-object sums."""
    from scipy.spatial import cKDTree

    b, oc = filt.shape
    out = np.zeros((7, oc))
    for i in range(b):
        for o in range(oc):
            n = counts[i, o, 0]
            X = pts[i, o, 0, :n].astype(np.float64)
            Pe, Pg, K = poses[i, o].astype(np.float64), poses_gt[i, o, 0].astype(np.float64), cams[i].astype(np.float64)
            has_pose = abs(Pe.sum()) > 1e-4
            present = filt[i, o] != 0
            out[4, o] += present and not has_pose
            out[5, o] += present
            out[6, o] += has_pose and not present
            if not (has_pose and present):
                out[0, o] += 99.9 if present else 0.0
                out[1, o] += 999.9 if present else 0.0
                continue
            ce, cg = X @ Pe[:, :3].T + Pe[:, 3], X @ Pg[:, :3].T + Pg[:, 3]
            ue, ug = ce @ K.T, cg @ K.T
            e2d = np.mean(np.linalg.norm(ug[:, :2] / ug[:, 2:] - ue[:, :2] / ue[:, 2:], axis=1))
            if n in (7862, 3417):
                e3d = np.mean(np.sqrt(cKDTree(ce).query(cg)[0] ** 2 + 1e-5))
            else:
                e3d = np.mean(np.linalg.norm(cg - ce, axis=1))
            out[0, o] += e2d
            out[1, o] += e3d
            out[2, o] += e2d < 5.0
            out[3, o] += e3d < 0.1 * diam[i, o, 0, 0]
    return out


def write_scene(root, n_images, seed=42):
    """An H x W (480x640), 8-object NDDS scene and its meshes: tools/synthetic_scene.py's generator at the
    flagship size.

    Objects on a 5-per-row pixel grid, back-projected at Z = 0.5 m; eval
    meshes of VERTEX_COUNTS vertices (mm), keypoint PLYs, models_info.json.
    """
    from PIL import Image

    names = [f"obj_{i:06d}" for i in range(1, OBJECTS + 1)]
    seg_ids = {name: 15 * (i + 1) for i, name in enumerate(names)}
    K = np.array(CAMERA)
    rng = np.random.default_rng(0)
    info, kp_mesh = {}, {}
    for name, n in zip(names, VERTEX_COUNTS):
        d = os.path.join(root, "models", name)
        os.makedirs(d)
        verts = rng.uniform(-30, 30, (n, 3))
        kp_mesh[name] = rng.uniform(-25, 25, (K_POINTS, 3))
        for fname, v in ((name + ".ply", verts), (name + "_keypoints.ply", kp_mesh[name])):
            with open(os.path.join(d, fname), "w") as f:
                f.write(f"ply\nformat ascii 1.0\nelement vertex {len(v)}\n")
                f.write("property float x\nproperty float y\nproperty float z\nend_header\n")
                f.writelines(f"{p[0]} {p[1]} {p[2]}\n" for p in v)
        info[name] = {"diameter": float(np.linalg.norm(verts.max(0) - verts.min(0)))}
    with open(os.path.join(root, "models", "models_info.json"), "w") as f:
        json.dump(info, f)
    scene = os.path.join(root, "data", "000000")
    os.makedirs(scene)
    fixed = np.diag([0.001, 0.001, 0.001, 1.0])
    with open(os.path.join(scene, "_object_settings.json"), "w") as f:
        json.dump({"exported_objects": [{"class": n, "segmentation_class_id": seg_ids[n],
                                         "fixed_model_transform": fixed.T.tolist()} for n in names]}, f)
    with open(os.path.join(scene, "_camera_settings.json"), "w") as f:
        json.dump({"camera_settings": [{"intrinsic_settings": {"fx": K[0, 0], "fy": K[1, 1], "cx": K[0, 2],
                                                               "cy": K[1, 2]}}]}, f)
    rng = np.random.default_rng(seed)
    for i in range(n_images):
        img = rng.integers(0, 255, (H, W, 3)).astype(np.uint8)
        blob = H * 36 // 480
        seg = np.zeros((H, W), np.uint8)
        objects = []
        for oi, name in enumerate(names):
            q = rng.normal(size=4)
            q /= np.linalg.norm(q)  # (w, x, y, z)
            R = quaternion_rotations(q[None])[0]
            px, py, z = W / 8 + W * 3 / 16 * (oi % 5), H / 6 + H / 3 * (oi // 5), 0.5
            t = np.array([(px - K[0, 2]) / K[0, 0] * z, (py - K[1, 2]) / K[1, 1] * z, z])
            kp3 = kp_mesh[name] * 0.001
            uvw = (kp3 @ R.T + t) @ K.T
            kp2 = uvw[:, :2] / uvw[:, 2:]
            cx, cy = kp2.mean(axis=0).astype(int)
            seg[max(cy - blob, 0) : cy + blob, max(cx - blob, 0) : cx + blob] = seg_ids[name]
            objects.append({"class": name, "visibility": 1.0, "location": t.tolist(),
                            "quaternion_xyzw": [q[1], q[2], q[3], q[0]], "keypoints_2d": kp2.tolist(),
                            "keypoints_3d": kp3.tolist(), "px_count_all": int((seg == seg_ids[name]).sum())})
        Image.fromarray(img).save(os.path.join(scene, f"{i:06d}.png"))
        Image.fromarray(seg).save(os.path.join(scene, f"{i:06d}.seg.png"))
        with open(os.path.join(scene, f"{i:06d}.json"), "w") as f:
            json.dump({"objects": objects}, f)
    return names


def phase_lm(dev, kernels):
    """7. The LM kernel driven as its caller drives it, counted; then held against its plain version."""
    import torch

    from casapose_tpu_torch.ops.pnp_kernel import lm_refine, lm_refine_plain

    t0 = time.time()
    B = 256
    R0, t0_, p2, p3, Kn, R_gt, t_gt = (torch.from_numpy(a).to(dev) for a in lm_problems(B, seed=0))
    lm_refine.launches = 0
    runs = {its: lm_refine(R0, t0_, p2, p3, Kn, iterations=its) for its in (10, 12)}
    torch.cuda.synchronize()
    kernels["lm_refine"] = {"launches_by_path": {"lm refinement (its caller, tests/test_pnp_kernel.py)": lm_refine.launches}}
    if lm_refine.launches == 0:
        raise AssertionError("lm_refine never launched its kernel")
    worst = 0.0
    for its, (R, t, err) in runs.items():
        Rp, tp, ep = lm_refine_plain(R0, t0_, p2, p3, Kn, iterations=its)
        R2, t2, e2 = lm_refine(R0, t0_, p2, p3, Kn, iterations=its)
        torch.cuda.synchronize()
        dR = (R - Rp).abs().max().item()
        dt = (t - tp).abs().max().item()
        gt_dt = (t - t_gt).abs().max().item()
        if not (dR <= 1e-4 and dt <= 2e-4):  # t atol 2e-4 as tests/test_pnp_kernel.py:58; R atol 1e-4
            raise AssertionError(f"lm_refine kernel disagrees with its plain version at {its} iterations: "
                                 f"|dR| {dR}, |dt| {dt}")
        if not (torch.equal(R, R2) and torch.equal(t, t2) and torch.equal(err, e2)):
            raise AssertionError("lm_refine: two runs differ in their bits")
        worst = max(worst, dR, dt)
        say("lm", t0, f"B={B}, {its} iterations: max|dR| {dR:.3g} max|dt| {dt:.3g} vs plain (atol R 1e-4, t 2e-4); "
            f"max err kernel {err.max().item():.3g}, plain {ep.max().item():.3g}; max|t - t_planted| {gt_dt:.3g}; "
            f"second run bit-identical")
    if not runs[12][2].max().item() < 1e-6:  # tests/test_pnp_kernel.py:45: exact convergence, no pixel noise
        raise AssertionError(f"lm_refine did not converge on noise-free problems: max err {runs[12][2].max().item()}")
    kernels["lm_refine"]["max_abs_err"] = worst
    return R0, t0_, p2, p3, Kn


def phase_eval(dev, kernels):
    """8. The evaluation step at full width, kernels against plain versions; launches counted per path."""
    import torch

    import casapose_tpu_torch.pose.epnp as epnp
    from casapose_tpu_torch.eval import build_test_step, loss_weights_from_opt
    from casapose_tpu_torch.models.registry import get_model
    from casapose_tpu_torch.ops.plain import plain_kernels
    from casapose_tpu_torch.ops.pnp_kernel import solve_pnp_kernel, solve_pnp_plain
    from casapose_tpu_torch.ops.voting_kernel import voting_accumulate
    from casapose_tpu_torch.pose.geometry import rodrigues, rotation_to_rvec

    t0 = time.time()
    opt = eval_opt(EVAL_CHUNK)
    model = get_model("casapose_c_gcu5", ver_dim=3 * K_POINTS, seg_dim=SEG_DIM, device=dev,
                      generator=torch.Generator().manual_seed(0))
    verts, counts = eval_meshes()
    step = build_test_step(model, opt, OBJECTS, verts, counts, loss_weights_from_opt(opt))
    planted = {b: planted_eval_batch(model, opt, b, seed=b, dev=dev) for b in (1, 32)}
    batches = {b: batch for b, (batch, _) in planted.items()}
    counters = {"voting": voting_accumulate, "pnp": solve_pnp_kernel}
    for fn in counters.values():
        fn.launches = 0
    # Each PnP kernel launch of the step, with its inputs, is recorded (the wrapper itself still counts it), so
    # that the kernel is held against its plain version on the inputs and at the B this path gives it.
    recorded = []

    def record(pts2d, pts3d, K, iterations=10):
        out = solve_pnp_kernel(pts2d, pts3d, K, iterations)
        recorded[-1].append((pts2d.clone(), pts3d.clone(), K.clone(), iterations) + tuple(x.clone() for x in out))
        return out

    outs, launches = {}, {}
    epnp.solve_pnp_kernel = record
    try:
        for b, batch in batches.items():
            recorded.append([])
            outs[b] = step(batch)
            launches[b] = recorded[-1]
    finally:
        epnp.solve_pnp_kernel = solve_pnp_kernel
    torch.cuda.synchronize()
    for name, fn in counters.items():
        kernels[name]["launches_by_path"]["eval step"] = fn.launches
    if any(fn.launches == 0 for fn in counters.values()):
        raise AssertionError(f"a kernel of the eval step never launched: { {n: f.launches for n, f in counters.items()} }")
    for b, out in outs.items():
        with plain_kernels():
            plain = step(batches[b])
        for key, v in out.items():
            vals = v if key == "pose_stats" else [v]
            if not all(torch.isfinite(x).all() for x in vals):
                raise AssertionError(f"eval b={b}: `{key}` is not finite")
        ps, pp = [x.cpu().numpy() for x in out["pose_stats"]], [x.cpu().numpy() for x in plain["pose_stats"]]
        torch.testing.assert_close(out["estimated_points"], plain["estimated_points"], rtol=1e-4, atol=5e-3)
        torch.testing.assert_close(out["losses"], plain["losses"], rtol=1e-4, atol=0.0)
        for i, name in ((2, "gt"), (6, "missing"), (7, "false positive")):
            if not np.array_equal(ps[i], pp[i]):
                raise AssertionError(f"eval b={b}: {name} counts differ, kernel {ps[i]} plain {pp[i]}")
        # The PnP kernel on this path, launch by launch: against its plain version on the same inputs (atol R
        # 1e-4, t 2e-4, as phase 3), and every present object's row on its planted pose (the same atol).
        shapes = [tuple(r[0].shape) for r in launches[b]]
        R, t, err = (torch.cat([r[4 + i] for r in launches[b]]) for i in range(3))
        Rp, tp, ep = (torch.cat(x) for x in zip(*(solve_pnp_plain(*r[:4]) for r in launches[b])))
        dR, dt = (R - Rp).abs().max().item(), (t - tp).abs().max().item()
        if not (dR <= 1e-4 and dt <= 2e-4):
            raise AssertionError(f"eval b={b}: PnP kernel disagrees with its plain version on the path's inputs: "
                                 f"|dR| {dR}, |dt| {dt}")
        truth = planted[b][1].reshape(-1, 3, 4)
        present = truth.abs().sum((1, 2)) > 0
        gt_dR = (R - truth[:, :, :3])[present].abs().max().item()
        gt_dt = (t - truth[:, :, 3])[present].abs().max().item()
        if not (gt_dR <= 1e-4 and gt_dt <= 2e-4):
            raise AssertionError(f"eval b={b}: PnP kernel missed planted poses: |dR| {gt_dR}, |dt| {gt_dt}")
        # What the step makes of the solve: R -> rvec (the p6d output) -> R, which amplifies rounding near 180 deg.
        trip = (rodrigues(rotation_to_rvec(R)) - rodrigues(rotation_to_rvec(Rp))).abs().amax((1, 2))
        d_trip, worst = trip.max().item(), int(trip.argmax())
        trip_deg = np.degrees(np.arccos(np.clip((R[worst].trace().item() - 1.0) / 2.0, -1.0, 1.0)))
        losses = out["losses"].cpu().numpy()
        say("eval", t0, f"b={b} (eval_chunk {EVAL_CHUNK}): outputs finite; max|d points| "
            f"{(out['estimated_points'] - plain['estimated_points']).abs().max().item():.3g} px (rtol 1e-4, atol 5e-3); "
            f"losses {np.array2string(losses, precision=6)}, max rel diff "
            f"{((out['losses'] - plain['losses']).abs() / plain['losses'].abs()).max().item():.3g} (rtol 1e-4); "
            f"gt {ps[2].sum():.0f}, missing {ps[6].sum():.0f}, false positive {ps[7].sum():.0f} (equal); PnP launches "
            f"{shapes}: kernel vs plain max|dR| {dR:.3g} max|dt| {dt:.3g} (atol R 1e-4, t 2e-4), on {int(present.sum())} "
            f"planted rows max|dR| {gt_dR:.3g} max|dt| {gt_dt:.3g}, max err kernel {err.max().item():.3g} plain "
            f"{ep.max().item():.3g}; after R -> rvec -> R max|dR| {d_trip:.3g} (rotation {trip_deg:.4f} deg); valid 2D "
            f"{ps[0].sum():.0f}/{pp[0].sum():.0f}, 3D {ps[1].sum():.0f}/{pp[1].sum():.0f}; error sums 2D "
            f"{ps[4].sum():.6g}/{pp[4].sum():.6g} px, 3D {ps[5].sum():.6g}/{pp[5].sum():.6g} m (kernel/plain, reported)")
    say("eval", t0, f"launches on the eval path: { {n: f.launches for n, f in counters.items()} }")
    return model, step, batches


def phase_metrics(dev):
    """9. evaluate_poses at M = 256, V = 7862 on planted poses against a float64 numpy oracle."""
    import torch

    from scipy.spatial import cKDTree
    from scipy.spatial.transform import Rotation

    from casapose_tpu_torch.pose.metrics import _closest_point_mean, evaluate_poses

    t0 = time.time()
    rng = np.random.default_rng(3)
    b, oc = 32, OBJECTS
    verts, counts1 = eval_meshes(seed=1)
    pts = np.ascontiguousarray(np.broadcast_to(verts[None, :, None], (b, oc, 1) + verts.shape[1:]))
    counts = np.ascontiguousarray(np.broadcast_to(counts1[None], (b, oc, 1)))
    poses_gt = np.zeros((b, oc, 1, 3, 4), np.float32)
    poses_gt[..., :3] = random_rotations(rng, b * oc).reshape(b, oc, 1, 3, 3)
    poses_gt[..., 3] = np.stack([rng.uniform(-0.1, 0.1, (b, oc)), rng.uniform(-0.1, 0.1, (b, oc)),
                                 rng.uniform(0.5, 1.2, (b, oc))], -1)[:, :, None]
    dR = Rotation.from_rotvec(rng.normal(scale=0.03, size=(b * oc, 3))).as_matrix()
    poses = np.concatenate([np.einsum("nij,njk->nik", dR, poses_gt[:, :, 0, :, :3].reshape(-1, 3, 3)),
                            poses_gt[:, :, 0, :, 3:].reshape(-1, 3, 1) + rng.normal(scale=0.005, size=(b * oc, 3, 1))],
                           -1).reshape(b, oc, 3, 4).astype(np.float32)
    filt = np.ones((b, oc), np.int32)
    poses[0, 2] = 0.0  # missing
    filt[1, 3] = 0  # false positive
    cams = np.broadcast_to(np.array(CAMERA, np.float32), (b, 3, 3)).copy()
    diam = np.full((b, oc, 1, 1), 0.1, np.float32)
    args = (poses, poses_gt, np.zeros((b, oc, K_POINTS, 2), np.float32), pts, counts, cams, diam, filt)
    got = np.stack([x.cpu().numpy() for x in evaluate_poses(*(torch.from_numpy(a).to(dev) for a in args))])
    want = evaluate_poses_oracle(poses, poses_gt, pts, counts, cams, diam, filt)
    if not np.array_equal(got[2:], want[2:]):
        raise AssertionError(f"evaluate_poses counts differ from the float64 oracle: {got[2:]} vs {want[2:]}")
    rel = np.abs(got[:2] - want[:2]) / np.abs(want[:2])
    if not (rel <= 1e-4).all():
        raise AssertionError(f"evaluate_poses error sums differ from the float64 oracle: worst rel {rel.max()}")
    # ADD-S per row, every one of the 256 rows symmetric, at V = 7862 with padding.
    cam_gt = pts[:, :, 0] @ np.swapaxes(poses_gt[:, :, 0, :, :3], -1, -2) + poses_gt[:, :, 0, None, :, 3]
    cam_est = pts[:, :, 0] @ np.swapaxes(poses[..., :3], -1, -2) + poses[:, :, None, :, 3]
    cam_gt, cam_est = cam_gt.reshape(b * oc, -1, 3), cam_est.reshape(b * oc, -1, 3)
    n = counts.reshape(-1)
    valid = np.arange(cam_gt.shape[1])[None] < n[:, None]
    t1 = time.time()
    adds = _closest_point_mean(*(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in
                                 (cam_gt.astype(np.float32), cam_est.astype(np.float32), valid.astype(np.float32), valid)))
    adds = adds.cpu().numpy()
    card_s = time.time() - t1
    oracle = np.array([np.mean(np.sqrt(cKDTree(cam_est[i, : n[i]].astype(np.float64))
                                       .query(cam_gt[i, : n[i]].astype(np.float64))[0] ** 2 + 1e-5))
                       for i in range(b * oc)])
    d = np.abs(adds - oracle)
    if not (d <= 1e-4 * oracle + 1e-6).all():
        raise AssertionError(f"ADD-S per row differs from the float64 oracle: worst {d.max()} m")
    say("metrics", t0, f"M={b * oc}, V={pts.shape[3]}: counts equal the float64 oracle (missing {got[4].sum():.0f}, "
        f"false positive {got[6].sum():.0f}, valid 3D {got[3].sum():.0f}); error sums worst rel {rel.max():.3g} "
        f"(rtol 1e-4); ADD-S on all {b * oc} rows in {card_s:.2f} s: worst |d| {d.max():.3g} m, rel "
        f"{(d / oracle).max():.3g} (rtol 1e-4 + 1e-6 m)")


def phase_eval_timings(model, step, batches, lm_inputs, kernels):
    """10. The eval step and its stages with CUDA events; the LM kernel, its plain version and bound."""
    import torch

    from casapose_tpu_torch.core.numerics import f32_precision
    from casapose_tpu_torch.data.pipeline import prepare_device_batch
    from casapose_tpu_torch.eval import loss_weights_from_opt
    from casapose_tpu_torch.losses.losses import composite_loss, keypoint_reprojection_loss, proxy_voting_dist
    from casapose_tpu_torch.ops.pnp_kernel import lm_refine, lm_refine_plain
    from casapose_tpu_torch.ops.vectorfield import get_all_vectorfields
    from casapose_tpu_torch.ops.voting import ls_voting
    from casapose_tpu_torch.pose.evaluation import evaluate_pose_estimates

    t0 = time.time()
    opt = eval_opt(EVAL_CHUNK)
    verts, counts = (torch.from_numpy(a).to(batches[1]["img"].device) for a in eval_meshes())
    for b, batch in batches.items():
        ms = cuda_ms(lambda: step(batch), 5 if b == 1 else 2, warmup=1)
        say("time", t0, f"eval step b={b} (eval_chunk {EVAL_CHUNK}): {ms:.3f} ms/step, {ms / b:.3f} ms/image")
        n = min(b, EVAL_CHUNK)  # the stages at the size the step runs them: one chunk
        c = {k: v[:n] for k, v in batch.items()}
        with torch.no_grad(), f32_precision():
            img, tseg = prepare_device_batch(c["img"], c["seg"], SEG_DIM)
            out = model(img, tseg)
            seg, dirs, conf = out[..., :SEG_DIM], out[..., SEG_DIM : SEG_DIM + 2 * K_POINTS], out[..., SEG_DIM + 2 * K_POINTS :]
            vote = lambda: ls_voting(tseg, dirs, conf, K_POINTS, filter_estimates=True, raw_output=out)  # noqa: E731
            coords = vote()
            kp = lambda: keypoint_reprojection_loss(  # noqa: E731
                coords, seg, c["poses_gt"], c["keypoints3d"], tseg, c["camera"], c["offsets"], conf,
                min_num=opt.min_object_size_test, min_num_gt=1, estimate_poses=True, filter_with_gt=False)
            kp_loss, poses_est, points_est = kp()

            def losses():
                target_dirs = get_all_vectorfields(tseg, c["keypoints2d"], c["seg"], False)
                composite_loss(seg, tseg, dirs, target_dirs, c["keypoints2d"], loss_weights_from_opt(opt), kp_loss=kp_loss)
                proxy_voting_dist(dirs, c["keypoints2d"], tseg[..., 1:], tseg[..., 0:1], invert_weights=True)

            stages = {
                "forward (batch finishing + network)": cuda_ms(
                    lambda: model(*prepare_device_batch(c["img"], c["seg"], SEG_DIM)), 3),
                "CC filter + voting": cuda_ms(vote, 3),
                "keypoint loss + PnP": cuda_ms(kp, 3),
                "metrics (ADD(-S)/2D)": cuda_ms(lambda: evaluate_pose_estimates(
                    points_est, poses_est, c["poses_gt"], tseg, c["keypoints3d"], c["camera"], c["diameters"],
                    evaluation_points=verts, object_points_3d_count=counts, min_num=1), 3),
                "losses (direction fields, composite, proxy)": cuda_ms(losses, 3),
            }
        say("time", t0, f"eval stages on {n} image(s), ms/image: "
            + "; ".join(f"{k} {v / n:.3f}" for k, v in stages.items()))

    R0, t0_, p2, p3, Kn = lm_inputs
    lm = kernels["lm_refine"]
    B = p2.shape[0]
    lm["kernel_ms"] = lm["ms"] = kernel_ms("lm_refine", lambda: lm_refine(R0, t0_, p2, p3, Kn, iterations=10))
    lm["call_ms"] = cuda_ms(lambda: lm_refine(R0, t0_, p2, p3, Kn, iterations=10), 20)
    lm["plain_ms"] = cuda_ms(lambda: lm_refine_plain(R0, t0_, p2, p3, Kn, iterations=10), 2)
    lm["library_ms"] = None
    l_bytes = B * (12 + K_POINTS * 5) * 4 + 16 + B * 13 * 4
    l_ops = B * lm_flops(K_POINTS, 10)
    lm["bound_ms"] = max(l_bytes / PEAK_BYTES_PER_S, l_ops / PEAK_F32_FLOP_PER_S) * 1e3
    lm["bound_by"] = "bytes" if l_bytes / PEAK_BYTES_PER_S >= l_ops / PEAK_F32_FLOP_PER_S else "operations"
    say("time", t0, f"lm_refine B={B}, 10 iterations: kernel_ms {lm['kernel_ms']:.4f} ({KERNEL_MS_METHOD['lm_refine']}), "
        f"call_ms {lm['call_ms']:.4f}, plain {lm['plain_ms']:.4f} ms, "
        f"bound {lm['bound_ms']:.6f} ms ({lm['bound_by']})")


def phase_harness():
    """11. python -m casapose_tpu_torch.eval on a written 480x640, 8-object scene, batch 32, eval_chunk 8."""
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        names = write_scene(tmp, n_images=40)
        say("harness", t0, f"wrote 40 images of {H}x{W} with {OBJECTS} objects")
        cmd = [sys.executable, "-m", "casapose_tpu_torch.eval", "-c", os.path.join(ROOT, "configs", "config_8.ini"),
               "--objects_to_copy_list", "", "--data", os.path.join(tmp, "none"), "--datatest", os.path.join(tmp, "data"),
               "--datameshes", os.path.join(tmp, "models"), "--object", ",".join(names), "--batchsize_test", "32",
               "--eval_chunk", str(EVAL_CHUNK), "--write_poses", "1", "--outf", os.path.join(tmp, "out"),
               "--evalf", os.path.join(tmp, "eval"), "--loginterval", "1"]
        proc = subprocess.run(cmd, cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0 or "== TEST == Finished" not in proc.stdout:
            raise AssertionError(f"the eval harness failed (rc {proc.returncode}):\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        with open(os.path.join(tmp, "eval", "loss_test_eval.csv")) as f:
            loss_rows = [r.split(",") for r in f.read().strip().splitlines()[1:]]
        with open(os.path.join(tmp, "eval", "test_summary_eval.csv")) as f:
            summary = f.read().strip().splitlines()
        values = [float(x) for r in loss_rows for x in r[1:]] + [float(x) for x in summary[1].split(",")]
        if len(loss_rows) != 2 or len(summary) != 2 or not np.isfinite(values).all():
            raise AssertionError(f"the eval harness wrote unexpected CSVs: {loss_rows} {summary}")
        n_poses = len(os.listdir(os.path.join(tmp, "eval", "poses_out", "all_poses")))
        tail = [ln for ln in proc.stdout.splitlines() if ln.startswith(("harness wall", "steady-state", "== TEST"))]
        say("harness", t0, f"2 batches (32 + 8 images), CSVs finite, {n_poses} pose files; "
            + " | ".join(tail) + f"; summary row: {summary[1]}")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from casapose_tpu_torch.core.numerics import f32_precision
    from casapose_tpu_torch.entry import build_inference_step
    from casapose_tpu_torch.ops import _build
    from casapose_tpu_torch.ops.plain import plain_kernels
    from casapose_tpu_torch.ops.pnp_kernel import solve_pnp_kernel, solve_pnp_plain
    from casapose_tpu_torch.ops.voting import class_masks, einsum_sums, filtered_labels, ls_voting
    from casapose_tpu_torch.ops.voting_kernel import voting_accumulate, voting_accumulate_plain
    from casapose_tpu_torch.pose.epnp import pose_matrix_from_p6d, solve_pnp, substitute_degenerate
    from casapose_tpu_torch.pose.evaluation import poses_pnp

    dev = torch.device("cuda")
    kernels = {}

    # 1. device
    t0 = time.time()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    say("device", t0, f"{kind}; torch {torch.__version__}; CUDA {torch.version.cuda}; "
        f"devices {torch.cuda.device_count()}; nvidia-smi: {smi}")

    # 2. build
    t0 = time.time()
    _build.build()
    for name in _build.SOURCES:
        report = [ln.strip() for ln in _build.ptxas_report(name).splitlines() if "registers" in ln or "spill" in ln]
        print(f"  ptxas {name}.cu: " + " | ".join(report), flush=True)
    say("build", t0, f"built {', '.join(s + '.cu' for s in _build.SOURCES)} into {_build.BUILD_DIR}")

    # 3. PnP kernel against its plain version, B = 256, N = 9
    t0 = time.time()
    B, n_random = 256, 8
    p2, p3, Kn, R_gt, t_gt = pnp_problems(B, n_random)
    p2c, p3c, Kc = (torch.from_numpy(a).to(dev) for a in (p2, p3, Kn))
    Rk, tk, ek = solve_pnp_kernel(p2c, p3c, Kc)
    Rk2, tk2, ek2 = solve_pnp_kernel(p2c, p3c, Kc)
    Rp, tp, ep = solve_pnp_plain(p2c, p3c, Kc)
    torch.cuda.synchronize()
    if not (torch.equal(Rk, Rk2) and torch.equal(tk, tk2) and torch.equal(ek, ek2)):
        raise AssertionError("PnP kernel: two runs differ in their bits")
    planted = slice(0, B - n_random)
    dR = (Rk - Rp).abs()[planted].max().item()
    dt = (tk - tp).abs()[planted].max().item()
    de = (ek - ep).abs()[planted].max().item()
    gt_dt = (tk[planted].cpu() - torch.from_numpy(t_gt[planted])).abs().max().item()
    rand_dR = (Rk - Rp).abs()[B - n_random :].max().item()
    rand_dt = (tk - tp).abs()[B - n_random :].max().item()
    if not (dR <= 1e-4 and dt <= 2e-4 and gt_dt <= 2e-4):  # t atol 2e-4 as tests/test_pnp_kernel.py:58
        raise AssertionError(f"PnP kernel disagrees on planted rows: |dR| {dR}, |dt| {dt}, |t - t_gt| {gt_dt}")
    zero = p2c.clone()
    zero[-8:] = 0.0
    p6d = solve_pnp(zero, p3c, Kc)
    placeholder = torch.tensor([0.0, 0.0, 0.0, 0.0, 0.0, 1.0], device=dev)
    if not (torch.equal(p6d[-8:], placeholder.expand(8, 6)) and torch.isfinite(p6d).all()):
        raise AssertionError("degenerate rows did not give the placeholder pose")
    kernels["pnp"] = {"max_abs_err": max(dR, dt)}
    say("pnp", t0, f"B={B}: planted max|dR| {dR:.3g} max|dt| {dt:.3g} max|derr| {de:.3g} (atol R 1e-4, t 2e-4); "
        f"kernel vs planted truth max|dt| {gt_dt:.3g}; random rows max|dR| {rand_dR:.3g} max|dt| {rand_dt:.3g}; "
        f"8 all-zero rows -> placeholder pose; second run bit-identical")
    kernels["pnp"]["kernel_ms_by_B"] = {}
    for Bs in (8, 64):  # the eval step's B at batch 1 and per chunk of 8: one block of 128 threads, partly filled
        p2s, p3s, Ks, _, t_s = (torch.from_numpy(a).to(dev) for a in pnp_problems(Bs, 0, seed=Bs))
        Rk, tk, ek = solve_pnp_kernel(p2s, p3s, Ks)
        Rp, tp, ep = solve_pnp_plain(p2s, p3s, Ks)
        torch.cuda.synchronize()
        dR, dt, gt_dt = ((Rk - Rp).abs().max().item(), (tk - tp).abs().max().item(), (tk - t_s).abs().max().item())
        if not (dR <= 1e-4 and dt <= 2e-4 and gt_dt <= 2e-4):
            raise AssertionError(f"PnP kernel disagrees at B={Bs}: |dR| {dR}, |dt| {dt}, |t - t_gt| {gt_dt}")
        kernels["pnp"]["max_abs_err"] = max(kernels["pnp"]["max_abs_err"], dR, dt)
        own = kernel_ms("pnp", lambda: solve_pnp_kernel(p2s, p3s, Ks))
        call = cuda_ms(lambda: solve_pnp_kernel(p2s, p3s, Ks), 20)
        kernels["pnp"]["kernel_ms_by_B"][Bs] = {"kernel_ms": own, "call_ms": call}
        say("pnp", t0, f"B={Bs} planted: max|dR| {dR:.3g} max|dt| {dt:.3g} (atol R 1e-4, t 2e-4); kernel vs planted "
            f"truth max|dt| {gt_dt:.3g}; kernel_ms {own:.4f} ({KERNEL_MS_METHOD['pnp']}), call_ms {call:.4f}")

    # 4. voting kernel against its plain version, b = 1 and 32
    t0 = time.time()
    for b in (1, 32):
        raw_np, lab_np = voting_inputs(b, seed=b)
        raw, lab = torch.from_numpy(raw_np).to(dev), torch.from_numpy(lab_np).to(dev)
        S1, Sp, err, plain_err, allowed = check_voting(raw, lab, SEG_DIM, K_POINTS)
        kernels.setdefault("voting", {"max_abs_err": 0.0})
        kernels["voting"]["max_abs_err"] = max(kernels["voting"]["max_abs_err"], (S1 - Sp).abs().max().item())
        timing = ""
        if b == 32:  # random dense labels: the worst case for any class-coherence path
            own = kernel_ms("voting", lambda: voting_accumulate(raw, lab, SEG_DIM, K_POINTS))
            kernels["voting"]["kernel_ms_random_labels"] = own
            timing = f"; kernel_ms on these random labels {own:.4f} ({KERNEL_MS_METHOD['voting']})"
        say("voting", t0, f"b={b} {H}x{W} C={CHANNELS}: vs float64 max|dS| kernel {err.max().item():.3g}, plain "
            f"{plain_err.max().item():.3g}; worst kernel |dS| / allowed {(err / allowed).max().item():.3g}, plain "
            f"{(plain_err / allowed).max().item():.3g}; kernel vs plain max|dS| {(S1 - Sp).abs().max().item():.3g}, "
            f"max|S| {Sp.abs().max().item():.4g}; second run bit-identical{timing}")
        del raw, lab, S1, Sp, err, plain_err, allowed
    # Shapes of other configurations: 13 objects (C = 41, records not 16-byte aligned, two class groups) and
    # 12 keypoints (two keypoint groups), b = 2.
    for objects, k in ((13, 9), (3, 12)):
        raw_np, lab_np = voting_inputs(2, seed=objects, seg_dim=objects + 1, k=k)
        raw, lab = torch.from_numpy(raw_np).to(dev), torch.from_numpy(lab_np).to(dev)
        _, _, err, _, allowed = check_voting(raw, lab, objects + 1, k)
        say("voting", t0, f"b=2 {objects} objects, {k} keypoints, C={raw.shape[-1]}: vs float64 max|dS| "
            f"{err.max().item():.3g}, worst |dS| / allowed {(err / allowed).max().item():.3g}; second run bit-identical")
        del raw, lab

    # 5. the flagship step, kernels and plain versions
    t0 = time.time()
    step, model = build_inference_step(OBJECTS, K_POINTS, H, W, device="cuda", generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    cases = []
    for b in (1, 32):
        kp3 = torch.from_numpy(rng.uniform(-0.05, 0.05, (b, OBJECTS, 1, K_POINTS, 3)).astype(np.float32)).to(dev)
        cam = torch.tensor(CAMERA, device=dev).expand(b, 3, 3).contiguous()
        noise = torch.from_numpy(rng.normal(size=(b, H, W, 3)).astype(np.float32)).to(dev)
        cases += [(f"zero b={b}", torch.zeros(b, H, W, 3, device=dev), kp3, cam), (f"noise b={b}", noise, kp3, cam)]
    launch_counters = {"voting": voting_accumulate, "pnp": solve_pnp_kernel}
    for fn in launch_counters.values():
        fn.launches = 0
    results = [step(img, kp3, cam, return_points=True) for _, img, kp3, cam in cases]
    torch.cuda.synchronize()
    for name, fn in launch_counters.items():
        kernels[name]["launches_by_path"] = {"inference step": fn.launches}
    if any(fn.launches == 0 for fn in launch_counters.values()):
        raise AssertionError(f"a kernel of the path never launched: { {n: f.launches for n, f in launch_counters.items()} }")
    for (label, img, kp3, cam), (poses, coords) in zip(cases, results):
        with plain_kernels():
            poses_p, coords_p = step(img, kp3, cam, return_points=True)
        if tuple(poses.shape) != (img.shape[0], OBJECTS, 1, 3, 4) or not torch.isfinite(poses).all():
            raise AssertionError(f"{label}: poses not finite or of the wrong shape {tuple(poses.shape)}")
        torch.testing.assert_close(coords, coords_p, rtol=1e-4, atol=5e-3)  # px, as tests/test_voting_kernel.py:78
        available = poses.abs().reshape(-1, 12).sum(1) > 0
        if not torch.equal(available, poses_p.abs().reshape(-1, 12).sum(1) > 0):
            raise AssertionError(f"{label}: the kernel and plain steps disagree on which objects are available")
        # Poses. Random weights vote all keypoints of an object within a few pixels, so against random
        # model points every PnP problem is ill-posed, and two solves rounded differently (the kernel
        # contracts multiply-adds, the plain version does not) may stop in different minima. The same
        # happens, more rarely, on this step's voted points with model keypoints made consistent with
        # them through a short-focal camera. Both are reported here; poses are held elementwise
        # against the plain version in phase 3, on planted problems at this batch's B = 256, and in
        # phase 8 on the eval step's voted points.
        e_k = reprojection_sq(poses, coords, kp3, cam)[available]
        e_p = reprojection_sq(poses_p, coords_p, kp3, cam)[available]
        kp3_w, cam_w = consistent_keypoints(coords, cam.shape[0])
        pts = coords.reshape(-1, K_POINTS, 2).flip(-1)
        pose_k = pose_matrix_from_p6d(solve_pnp(pts, kp3_w.reshape(-1, K_POINTS, 3), cam_w[0]))
        with plain_kernels("pnp"):
            pose_p = pose_matrix_from_p6d(solve_pnp(pts, kp3_w.reshape(-1, K_POINTS, 3), cam_w[0]))
        r_k = reprojection_sq(pose_k, coords, kp3_w, cam_w)[available]
        r_p = reprojection_sq(pose_p, coords, kp3_w, cam_w)[available]
        ratio = (e_k / e_p.clamp(min=1e-12)).max().item() if available.any() else 1.0
        say("step", t0, f"{label}: poses {tuple(poses.shape)} finite, {int(available.sum())} available, the same for "
            f"both; max|d points| {(coords - coords_p).abs().max().item():.3g} px (rtol 1e-4, atol 5e-3); random "
            f"keypoints: worst reprojection kernel/plain {ratio:.4g}; consistent keypoints: exact (< 1e-4 px^2) "
            f"kernel {int((r_k < 1e-4).sum())}, plain {int((r_p < 1e-4).sum())}, kernel worse by > 0.1% on "
            f"{int((r_k > r_p * 1.001 + 1e-4).sum())}, plain worse on {int((r_p > r_k * 1.001 + 1e-4).sum())}")
    say("step", t0, f"launches on the main path: { {n: kernels[n]['launches_by_path'] for n in launch_counters} }")
    del results

    # 6. timings: the step, its stages (as the step runs them: no grad, TF32 off), then each kernel
    t0 = time.time()
    for label, img, kp3, cam in cases:
        if label.startswith("noise"):
            b = img.shape[0]
            iters = 10 if b == 1 else 3
            ms = cuda_ms(lambda: step(img, kp3, cam), iters, warmup=2)
            say("time", t0, f"step {label}: {ms:.3f} ms/step, {ms / b:.3f} ms/image")
            with torch.no_grad(), f32_precision():
                out = model(img)
                seg, dirs, conf = out[..., :SEG_DIM], out[..., SEG_DIM : SEG_DIM + 2 * K_POINTS], out[..., SEG_DIM + 2 * K_POINTS :]
                coords = ls_voting(seg, dirs, conf, K_POINTS, filter_estimates=True, raw_output=out)
                stages = {
                    "network": cuda_ms(lambda: model(img), iters),
                    "class masks + CC filter": cuda_ms(lambda: filtered_labels(*class_masks(seg, torch.float32, True)), iters),
                    "ls_voting (filter, kernel, 2x2 solve)": cuda_ms(
                        lambda: ls_voting(seg, dirs, conf, K_POINTS, filter_estimates=True, raw_output=out), iters
                    ),
                    "poses_pnp": cuda_ms(lambda: poses_pnp(coords, seg, kp3, cam, OBJECTS), iters),
                }
            say("time", t0, f"stages {label}: " + "; ".join(f"{k} {v:.3f} ms" for k, v in stages.items()))
    _, img, kp3, cam = cases[-1]  # noise b=32: the main path's own kernel inputs
    with torch.no_grad(), f32_precision():
        out = model(img)
    seg, dirs, conf = out[..., :SEG_DIM], out[..., SEG_DIM : SEG_DIM + 2 * K_POINTS], out[..., SEG_DIM + 2 * K_POINTS :]
    labels, hot = class_masks(seg, torch.float32, True)
    lab_f = filtered_labels(labels, hot)
    coords = step(img, kp3, cam, return_points=True)[1]
    pts2d, _ = substitute_degenerate(coords.reshape(-1, K_POINTS, 2).flip(-1), kp3.reshape(-1, K_POINTS, 3), cam[0])
    pts2d, pts3d, K0 = pts2d.contiguous(), kp3.reshape(-1, K_POINTS, 3).contiguous(), cam[0].contiguous()

    n_fg = int((lab_f > 0).sum())
    b = img.shape[0]
    vote = kernels["voting"]
    vote["kernel_ms"] = vote["ms"] = kernel_ms("voting", lambda: voting_accumulate(out, lab_f, SEG_DIM, K_POINTS))
    vote["call_ms"] = cuda_ms(lambda: voting_accumulate(out, lab_f, SEG_DIM, K_POINTS), 20)
    vote["plain_ms"] = cuda_ms(lambda: voting_accumulate_plain(out, lab_f, SEG_DIM, K_POINTS), 3)
    vote["library_ms"] = cuda_ms(lambda: einsum_sums(hot, dirs, conf, False), 3)
    v_bytes = lab_f.numel() * 4 + n_fg * 3 * K_POINTS * 4 + b * OBJECTS * K_POINTS * 6 * 4
    v_ops = n_fg * K_POINTS * 32  # direction, softplus, 6 features, 6 sums per pixel and keypoint
    vote["bound_ms"] = max(v_bytes / PEAK_BYTES_PER_S, v_ops / PEAK_F32_FLOP_PER_S) * 1e3
    vote["bound_by"] = "bytes" if v_bytes / PEAK_BYTES_PER_S >= v_ops / PEAK_F32_FLOP_PER_S else "operations"
    # What these labels ask of the kernel, which copies whole 32-pixel segments that hold a labelled pixel.
    classes = sum((lab_f.reshape(-1, 32) == c).any(1).int() for c in range(1, SEG_DIM))
    mixed = (classes >= 2).float().mean().item()
    copied_gb = (int((classes >= 1).sum()) * 32 * CHANNELS * 4 + lab_f.numel() * 4) / 1e9
    say("time", t0, f"voting b={b}: {mixed:.1%} of the 32-pixel segments mix classes, the kernel copies "
        f"{copied_gb:.3f} GB against the bound's {v_bytes / 1e9:.3f} GB")
    say("time", t0, f"voting b={b}: kernel_ms {vote['kernel_ms']:.4f} ({KERNEL_MS_METHOD['voting']}), "
        f"{vote['bound_ms'] / vote['kernel_ms']:.1%} of the bound; call_ms {vote['call_ms']:.4f}, plain {vote['plain_ms']:.4f} ms, einsum form "
        f"{vote['library_ms']:.4f} ms, bound {vote['bound_ms']:.4f} ms ({vote['bound_by']}; {n_fg} labelled px)")

    Bp = pts2d.shape[0]
    pnp = kernels["pnp"]
    pnp["kernel_ms"] = pnp["ms"] = kernel_ms("pnp", lambda: solve_pnp_kernel(pts2d, pts3d, K0))
    pnp["call_ms"] = cuda_ms(lambda: solve_pnp_kernel(pts2d, pts3d, K0), 20)
    pnp["kernel_ms_by_B"][Bp] = {"kernel_ms": pnp["kernel_ms"], "call_ms": pnp["call_ms"]}
    pnp["plain_ms"] = cuda_ms(lambda: solve_pnp_plain(pts2d, pts3d, K0), 2)
    pnp["library_ms"] = None
    p_bytes = Bp * K_POINTS * 5 * 4 + 16 + Bp * 13 * 4
    p_ops = Bp * pnp_flops(K_POINTS, 10)
    pnp["bound_ms"] = max(p_bytes / PEAK_BYTES_PER_S, p_ops / PEAK_F32_FLOP_PER_S) * 1e3
    pnp["bound_by"] = "bytes" if p_bytes / PEAK_BYTES_PER_S >= p_ops / PEAK_F32_FLOP_PER_S else "operations"
    say("time", t0, f"pnp B={Bp}: kernel_ms {pnp['kernel_ms']:.4f} ({KERNEL_MS_METHOD['pnp']}), call_ms "
        f"{pnp['call_ms']:.4f}, plain {pnp['plain_ms']:.4f} ms, "
        f"bound {pnp['bound_ms']:.6f} ms ({pnp['bound_by']})")

    del out, seg, dirs, conf, labels, hot, lab_f, coords, cases
    lm_inputs = phase_lm(dev, kernels)  # 7
    eval_model, eval_step, eval_batches = phase_eval(dev, kernels)  # 8
    phase_metrics(dev)  # 9
    phase_eval_timings(eval_model, eval_step, eval_batches, lm_inputs, kernels)  # 10
    del eval_model, eval_step, eval_batches
    torch.cuda.empty_cache()
    phase_harness()  # 11

    meta = {
        "voting": ("casapose_tpu_torch/csrc/voting.cu", "casapose_tpu/ops/voting_kernel.py:103"),
        "pnp": ("casapose_tpu_torch/csrc/pnp.cu", "casapose_tpu/ops/pnp_kernel.py:489"),
        "lm_refine": ("casapose_tpu_torch/csrc/pnp.cu", "casapose_tpu/ops/pnp_kernel.py:167"),
    }
    line = []
    for name, (source, replaces) in meta.items():
        k = kernels[name]
        line.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": sum(k["launches_by_path"].values()), "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                     "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
                     "library_ms": k["library_ms"], "kernel_ms": k["kernel_ms"], "call_ms": k["call_ms"],
                     "kernel_ms_method": KERNEL_MS_METHOD[name], "launches_by_path": k["launches_by_path"],
                     **{key: k[key] for key in ("kernel_ms_by_B", "kernel_ms_random_labels") if key in k}})
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
