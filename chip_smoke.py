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
     voting, the CC labels by the CC kernel -> EPnP+LM) at 480x640, 8 objects, 9 keypoints, float32 with
     TF32 off, random weights from a seed, at batch 1 and 32 on a zero and a
     noise image; every kernel must launch, every pose must be finite, and
     the voted points must agree with the same step run through the
     kernels' plain versions on the card, and every CC launch's labels equal
     the plain loop's on its masks (sweeps counted); how the two steps' poses
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
     --batchsize_test 32 --eval_chunk 8;
 12. models: every name of the registry at 480x640, batch 1, float32 (the
     11 CASAPose variants, casapose_custom also from a decoder string,
     pvnet and pvnet_combined, on resnet18; casapose_c_gcu5 on resnet34,
     50, 101 and 152): output shape, finiteness and forward ms;
 13. eval paths: three more evaluation steps at full width, each driven as
     phase 8 drives the flagship's (launches counted under the path's own
     name, each voting launch against float64, each PnP launch against
     plain_kernels("pnp") on the same points, the whole step against its
     run with the plain PnP), with ms/image and peak memory: casapose_c_gcu4_bilat on
     resnet50 at batch 32, eval_chunk 8; pvnet down the RANSAC branch
     (estimate_coords 0, 20 rounds) at batch 4; the flagship with
     compute_dtype bfloat16 at batch 32, eval_chunk 8;
 14. bf16: the inference step with the bfloat16 network (bench.py's dtype)
     at batch 1 and 32, its kernels counted and held as in phase 5, its
     stages timed as in phase 6 and printed beside phase 6's float32;
 15. train: the configs/config_8.ini train step (casapose_c_gcu5, 448x448,
     8 objects, 9 keypoints, batch-statistics BatchNorm, AdamTF) at float32
     batch 4, bfloat16 batch 8 (the JAX bench's shape) and float32 batch 8,
     30 steps each on one seeded batch: the total loss must fall and every
     gradient be finite, the bf16 loss stay within its band of the float32
     run's; step ms, ms/image, the forward / backward / optimizer split
     (CUDA events) and peak memory;
 16. bpnp: the train step with use_bpnp_reprojection_loss 1 at B = 32 (batch
     4 x 8 objects) on planted, well-posed problems (each object 60 pixels
     scattered over the image, so that its votes spread; a 128-px focal
     length): the PnP launch of its first step (the BPnP forward) against
     its plain version (atol R 1e-4, t 2e-4) on the rows whose plain solve
     finds the planted pose, the BPnP input gradients at the kernel's
     solutions against those at the plain version's (rtol 1e-3, rows under
     172 degrees), the implicit-function backward timed;
 17. train harness: run_training (python -m casapose_tpu_torch.train's
     driver) on a written 480x640, 8-object scene at 448x448 crops: 2 epochs
     with pose validation (the PnP kernel) and a checkpoint each, then a
     resume from step_2 for a third; the harness's own lines and img/s;
 18. precision: --matmul_precision high (TF32 in cuBLAS and cuDNN) against
     highest: the config_8 train step at float32 batch 4 (30 steps each:
     step ms, the forward / backward / optimizer split, aten::bmm's device
     time, the loss within 0.1% of highest's at the first step and 1%
     over the last 5) and the float32 inference step at batch 32
     (ms/image, its kernels counted, the network's output on one class
     mask within 1e-2 of its max from highest's);
 19. remat: the float32 batch-8 train step with --remat against without,
     one step from the same weights with cuDNN's deterministic algorithms
     (losses and running statistics at rtol 1e-5, atol 1e-6, gradients and
     weights as compare_train_steps says, a second run without remat for
     the run-to-run spread); step ms and peak memory of both;
 20. ddp: the trainer's data-parallel path (build_train_step with a NCCL
     group of world size 1 on a free port) against the same step without
     it, and its cost per step; with two cards or more, two ranks against
     one at the same global batch;
 21. harness options on a written 480x640 scene: run_training with the
     expansion surgery from a port-written 4-object backup .npz (the copied
     rows bit for bit), --save_debug_batch, --profile_dir (a trace of CUDA
     kernels), and run_evaluation with --save_eval_batches 1 --profile_dir
     (the visual files, the PnP kernel in the trace); h5py's absence said;
 22. int8: the inference step with int8-quantized convolutions (quantized="int8")
     at batch 1 and 32, its kernels counted and held as in phase 14, its stages
     timed beside phases 6 and 14; one backbone conv's and one masked partial
     conv's codes and int32 sums on the card equal to the CPU's bit for bit;
     the network output against float32 within tests/test_quant.py's bands
     (median 0.02, p99 0.05 of each head's max, segmentation worst case
     0.15); the int8 eval step at batch 32, eval_chunk 8, driven as phase 13
     drives its paths, with ms/image and peak memory;
 23. bf16c: LS voting at b=32 on phase 6's inputs with CASAPOSE_VOTING_FORM=bf16c,
     the einsum form and the voting kernel, each against float64 (bf16c's
     median under 1 px; the maxima reported), and the form's ms beside the
     kernel's kernel_ms;
 24. xla pnp: solve_pnp with CASAPOSE_PNP_REFINE=xla against the PnP kernel on
     planted problems at B = 8, 64 and 256 (R atol 1e-4, t 2e-4), its call_ms
     beside the kernel's;
 25. export: the float32 serving program (core/export.py) at 480x640, batch 1,
     exported on the card, saved, loaded and called: poses within 1e-6 of the
     live function's, the voting and PnP launches counted inside the loaded
     program, its size, export seconds and ms per call;
 26. clis: python -m casapose_tpu_torch.test_minimal and python -m
     casapose_tpu_torch.export_model on a written 480x640 scene;
 27. cc: the CC kernel (csrc/cc.cu, the JAX package's lax.while_loop of flood
     sweeps in one launch) against its plain loop on the main path's own
     masks (b=32, 256 of 120x160, shared memory), at full resolution (the
     same batch's 480x640 class masks, device memory) and on two serpentines
     that reach the 64-sweep cap: labels exactly equal, sweeps counted,
     kernel_ms, call_ms, the plain loop's ms and a bound. Phases 5, 8, 13,
     14 and 22 hold each CC launch of their paths against the plain loop and
     count its sweeps and the masks at the cap;
 28. sync: the inference step (float32, bfloat16) and the LS eval step
     (float32, bfloat16) at batch 1 and 32 under
     torch.cuda.set_sync_debug_mode("error"), after one call each;
 29. pipeline: the eval harness serial (CASAPOSE_EVAL_PIPELINE=0) against
     pipelined on a written 480x640 scene of 12 batches of 4, serial,
     pipelined, pipelined, serial: files equal apart from the time columns,
     steady img/s and host phases of each run;
 30. converter: python -m casapose_tpu_torch.dataset_converter on a
     synthetic BOP scene written here (render and reuse masks), then the
     eval harness on the converted scene.
Then a "kernels" JSON line (voting, pnp, lm_refine, and cc, which replaces
no pallas_call), and as the last line
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
import warnings

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
    err, allowed = voting_vs_float64(S1, S64, seg_dim, k)
    plain_err = (Sp.double() - S64).abs()
    if not torch.equal(S1, S2):
        raise AssertionError("voting kernel: two runs differ in their bits")
    return S1, Sp, err, plain_err, allowed


def voting_vs_float64(S, S64, seg_dim, k):
    """|S - S64| and the allowed error; raises if the kernel's sums S are outside it.

    Held against the plain version in float64, as tests/test_voting_kernel.py:51 holds the Pallas
    kernel against a float64 oracle: atol 2e-4 plus rtol 2e-5 of the sum of |terms|. A class here
    sums ~34,000 terms whose signed features cancel, so float32 rounding in ANY order is ~1e-7 of
    that absolute sum, not of |S|. |a|, |b|, |d| <= w and |qy|, |qx| <= w (1 + W/H) bound it by the
    weight mass S[..., 5].
    """
    import torch

    scale = torch.tensor([1.0, 1.0, 1.0, 1 + W / H, 1 + W / H, 1.0], device=S.device, dtype=torch.float64)
    allowed = 2e-4 + 2e-5 * S64[..., 5:6] * scale
    err = (S.double() - S64).abs()
    if not (err <= allowed).all():
        raise AssertionError(f"voting kernel disagrees with float64 (seg_dim {seg_dim}, k {k}): worst |dS| / allowed "
                             f"{(err / allowed).max().item()}")
    return err, allowed


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


def planted_eval_batch(model, opt, b, seed, dev, camera=None):
    """:func:`eval_batch` with well-posed PnP problems for the step's own voted points, as tensors on ``dev``.

    The step votes on the GT segmentation (train_vectors_with_ground_truth),
    so its voted points depend only on it and the network's direction
    channels (int8-quantized under ``--quantized_inference int8``): vote
    here, one chunk at a time as the step does, then plant the keypoints
    (:func:`plant_keypoints`).
    """
    import torch

    from casapose_tpu_torch.core.numerics import f32_precision
    from casapose_tpu_torch.data.pipeline import prepare_device_batch
    from casapose_tpu_torch.ops.quant import quantized_apply
    from casapose_tpu_torch.ops.voting import ls_voting

    batch = eval_batch(b, seed)
    coords = []
    forward = quantized_apply if opt.quantized_inference == "int8" else (lambda m, x, g: m(x, g))
    with torch.no_grad(), f32_precision():
        for i in range(0, b, EVAL_CHUNK):
            img, tseg = prepare_device_batch(*(torch.from_numpy(batch[k][i : i + EVAL_CHUNK]).to(dev) for k in ("img", "seg")),
                                             SEG_DIM, grayscale_to_rgb=not opt.color_dataset)
            out = forward(model, img, tseg)
            coords.append(ls_voting(
                tseg, out[..., SEG_DIM : SEG_DIM + 2 * K_POINTS], out[..., SEG_DIM + 2 * K_POINTS :], num_points=K_POINTS,
                filter_estimates=bool(opt.confidence_filter_estimates),
                output_second_largest_component=bool(opt.confidence_choose_second),
                cc_downsample=int(opt.cc_filter_downsample), raw_output=out).double().cpu().numpy())
    return plant_keypoints(batch, np.concatenate(coords), dev, camera)


def plant_keypoints(batch, coords, dev, camera=None):
    """Make ``batch``'s PnP problems well-posed for voted points ``coords`` [b, oc, k, 2] (y, x); tensors on ``dev``.

    Each present object's model keypoints go where a planted pose projects
    them exactly onto its voted points through ``camera`` (default CAMERA;
    depths 0.75 to 0.85 m), which becomes the batch's camera. poses_gt is the planted pose
    moved by (6, -4, 8) cm, so that the keypoint loss is not ~0, and
    keypoints2d its projections, as the loader writes them. Absent objects
    stay as the loader writes them. Returns (batch, planted poses [b, oc, 3,
    4], zero where absent).
    """
    import torch

    b = coords.shape[0]
    pts = np.asarray(coords, np.float64).reshape(-1, K_POINTS, 2)  # (y, x)
    rng = np.random.default_rng(5)
    n = b * OBJECTS
    K = np.array(CAMERA if camera is None else camera, np.float64)
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
    batch = dict(batch)
    batch["camera"] = np.ascontiguousarray(np.broadcast_to(K, (b, 3, 3)), np.float32)
    batch["keypoints3d"] = np.where(present, model_pts, batch["keypoints3d"]).astype(np.float32)
    batch["poses_gt"] = np.where(present, poses_gt, 0.0).astype(np.float32)
    batch["keypoints2d"] = np.where(present, kp2d, -1000.0).astype(np.float32)
    planted = np.where(present[:, :, 0], planted, 0.0).astype(np.float32)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in batch.items()}, torch.from_numpy(planted).to(dev)


def eval_opt(chunk, *flags):
    """The flagship evaluation config (configs/config_8.ini) with --eval_chunk and any further flags."""
    from casapose_tpu_torch.utils.config import parse_config

    return parse_config(["-c", os.path.join(ROOT, "configs", "config_8.ini"), "--objects_to_copy_list", "",
                         "--eval_chunk", str(chunk), "--outf", "chip_smoke/unused", *flags])


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


def inference_stage_ms(step, model, img, kp3, cam, forward=None):
    """ms of the inference step and of its stages, as the step runs them (no grad, TF32 off), with CUDA events.
    ``forward(img)`` is the step's network (default ``model``)."""
    import torch

    from casapose_tpu_torch.core.numerics import f32_precision
    from casapose_tpu_torch.ops.voting import class_masks, filtered_labels, ls_voting
    from casapose_tpu_torch.pose.evaluation import poses_pnp

    forward = forward or model
    iters = 10 if img.shape[0] == 1 else 3
    times = {"step": cuda_ms(lambda: step(img, kp3, cam), iters, warmup=2)}
    with torch.no_grad(), f32_precision():
        out = forward(img)
        seg, dirs, conf = out[..., :SEG_DIM], out[..., SEG_DIM : SEG_DIM + 2 * K_POINTS], out[..., SEG_DIM + 2 * K_POINTS :]
        coords = ls_voting(seg, dirs, conf, K_POINTS, filter_estimates=True, raw_output=out)
        times.update({
            "network": cuda_ms(lambda: forward(img), iters),
            "class masks + CC filter": cuda_ms(lambda: filtered_labels(*class_masks(seg, torch.float32, True)), iters),
            "ls_voting (filter, kernel, 2x2 solve)": cuda_ms(
                lambda: ls_voting(seg, dirs, conf, K_POINTS, filter_estimates=True, raw_output=out), iters),
            "poses_pnp": cuda_ms(lambda: poses_pnp(coords, seg, kp3, cam, OBJECTS), iters),
        })
    return times


# Every model of the registry (phase 12): the names on resnet18, then the flagship on the other backbones.
CUSTOM_DECODER = "10001,10010,00000,10000,11001"
REGISTRY_MODELS = [(name, "resnet18", None) for name in (
    "casapose_c", "casapose_c_gu", "casapose_c_gcu3", "casapose_c_gcu4", "casapose_c_gcu5", "casapose_custom",
    "casapose_c_gcu5_sw5", "casapose_c_gcu4_sw1", "casapose_c_gcu5_sw1", "casapose_c_gcu4_bilat",
    "casapose_c_gcu4_sw2")] + [("casapose_custom", "resnet18", CUSTOM_DECODER), ("pvnet", "resnet18", None),
                               ("pvnet_combined", "resnet18", None)] + [
    ("casapose_c_gcu5", base, None) for base in ("resnet34", "resnet50", "resnet101", "resnet152")]


def phase_models(dev):
    """12. Every registry name at 480x640, batch 1, float32: output shape, finiteness, forward ms."""
    import torch

    from casapose_tpu_torch.core.numerics import f32_precision
    from casapose_tpu_torch.models.registry import PVNET_NAMES, get_model

    t0 = time.time()
    img = torch.from_numpy(np.random.default_rng(12).normal(size=(1, H, W, 3)).astype(np.float32)).to(dev)
    for name, base, decoder in REGISTRY_MODELS:
        ver_dim = 2 * K_POINTS * OBJECTS if name in PVNET_NAMES else 3 * K_POINTS
        model = get_model(name, ver_dim, SEG_DIM, base_model=base, decoder_params=decoder, device=dev,
                          generator=torch.Generator().manual_seed(0))
        with torch.no_grad(), f32_precision():
            out = model(img)
            ms = cuda_ms(lambda: model(img), 5, warmup=1)
        torch.cuda.synchronize()
        if tuple(out.shape) != (1, H, W, SEG_DIM + ver_dim) or not torch.isfinite(out).all():
            raise AssertionError(f"{name} on {base}: output {tuple(out.shape)} not finite or of the wrong shape")
        say("models", t0, f"{name}{' (' + decoder + ')' if decoder else ''} on {base}: output {tuple(out.shape)} "
            f"finite; forward {ms:.3f} ms")
        del model, out
        torch.cuda.empty_cache()


def phase_eval_paths(dev, kernels):
    """13. Three more eval paths at full width, each with its launches counted under its own name."""
    import torch

    from casapose_tpu_torch.eval import build_test_step, loss_weights_from_opt
    from casapose_tpu_torch.models.registry import build_model_from_opt

    t0 = time.time()
    verts, counts = eval_meshes()
    # A variant's voted points can cluster within a few pixels with one far off; seen through the 480x640 camera
    # such planted problems have several minima. A 128-px focal length makes the same pixels a wide angle.
    short = [[128.0, 0.0, W / 2], [0.0, 128.0, H / 2], [0.0, 0.0, 1.0]]
    paths = [
        ("eval step casapose_c_gcu4_bilat on resnet50", 32, ("voting", "pnp", "cc"),
         eval_opt(EVAL_CHUNK, "--modelname", "casapose_c_gcu4_bilat", "--backbonename", "resnet50")),
        ("eval step pvnet RANSAC", 4, ("pnp",),
         eval_opt(0, "--modelname", "pvnet", "--estimate_confidence", "0", "--estimate_coords", "0",
                  "--ransac_rounds", "20")),
        ("eval step casapose_c_gcu5 bfloat16", 32, ("voting", "pnp", "cc"),
         eval_opt(EVAL_CHUNK, "--compute_dtype", "bfloat16")),
    ]
    for label, b, path_kernels, opt in paths:
        model = build_model_from_opt(opt, OBJECTS, device=dev, generator=torch.Generator().manual_seed(0))
        step = build_test_step(model, opt, OBJECTS, verts, counts, loss_weights_from_opt(opt))
        if opt.estimate_coords:
            planted = planted_eval_batch(model, opt, b, seed=b, dev=dev, camera=short)
        else:  # RANSAC votes on the predicted masks: vote with the step itself, then plant the keypoints
            raw = eval_batch(b, b)
            points = step({k: torch.from_numpy(v).to(dev) for k, v in raw.items()})["estimated_points"]
            planted = plant_keypoints(raw, points.flip(-1).cpu().numpy(), dev, short)
        # The whole step is rerun with the PnP kernel's plain version only: on a variant's voted points a 2x2
        # voting system can be near-singular (its pixels' directions near-parallel), where a float32 rounding of
        # the sums moves the point by pixels (casapose_c_gcu4_bilat on resnet50 at batch 32 on an H100: 97 of
        # 4608 coordinates, up to 3.9 px, between the voting kernel and its plain version); each voting launch
        # is held against float64 instead.
        drive_eval_path(label, step, {b: planted}, kernels, path_kernels, t0, phase="eval paths", hold_planted=False,
                        plain=("pnp",))
        batch = planted[0]
        ms = cuda_ms(lambda: step(batch), 2, warmup=1)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        step(batch)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        chunk = f", eval_chunk {opt.eval_chunk}" if opt.eval_chunk else ""
        say("eval paths", t0, f"{label} b={b}{chunk}: {ms:.3f} ms/step, {ms / b:.3f} ms/image; peak memory "
            f"{peak / 2**30:.2f} GiB ({(peak - base) / 2**30:.2f} GiB above the {base / 2**30:.2f} GiB held before the step)")
        del model, step, batch, planted
        torch.cuda.empty_cache()


def phase_bf16_inference(dev, kernels, f32_times):
    """14. The inference step in bfloat16 (bench.py's network dtype), batch 1 and 32, beside phase 6's float32."""
    import torch

    from casapose_tpu_torch.entry import build_inference_step
    from casapose_tpu_torch.ops.connected_components import connected_components_kernel
    from casapose_tpu_torch.ops.plain import plain_kernels
    from casapose_tpu_torch.ops.pnp_kernel import solve_pnp_kernel
    from casapose_tpu_torch.ops.voting_kernel import voting_accumulate

    t0 = time.time()
    step, model = build_inference_step(OBJECTS, K_POINTS, H, W, device="cuda", generator=torch.Generator().manual_seed(0),
                                       dtype=torch.bfloat16)
    rng = np.random.default_rng(14)
    cases = []
    for b in (1, 32):
        kp3 = torch.from_numpy(rng.uniform(-0.05, 0.05, (b, OBJECTS, 1, K_POINTS, 3)).astype(np.float32)).to(dev)
        cam = torch.tensor(CAMERA, device=dev).expand(b, 3, 3).contiguous()
        cases.append((b, torch.from_numpy(rng.normal(size=(b, H, W, 3)).astype(np.float32)).to(dev), kp3, cam))
    counters = {"voting": voting_accumulate, "pnp": solve_pnp_kernel, "cc": connected_components_kernel}
    for fn in counters.values():
        fn.launches = 0
    with cc_recording() as cc_records:
        results = [step(img, kp3, cam, return_points=True) for _, img, kp3, cam in cases]
    torch.cuda.synchronize()
    for name, fn in counters.items():
        kernels[name]["launches_by_path"]["inference step bfloat16"] = fn.launches
    if any(fn.launches == 0 for fn in counters.values()):
        raise AssertionError(f"a kernel of the bf16 step never launched: { {n: f.launches for n, f in counters.items()} }")
    hold_cc("inference step bfloat16", cc_records, kernels, t0, "bf16")
    bf16_times = {}
    for (b, img, kp3, cam), (poses, coords) in zip(cases, results):
        with plain_kernels():
            poses_p, coords_p = step(img, kp3, cam, return_points=True)
        if tuple(poses.shape) != (b, OBJECTS, 1, 3, 4) or not torch.isfinite(poses).all():
            raise AssertionError(f"bf16 step b={b}: poses not finite or of the wrong shape {tuple(poses.shape)}")
        torch.testing.assert_close(coords, coords_p, rtol=1e-4, atol=5e-3)
        available = poses.abs().reshape(-1, 12).sum(1) > 0
        if not torch.equal(available, poses_p.abs().reshape(-1, 12).sum(1) > 0):
            raise AssertionError(f"bf16 step b={b}: the kernel and plain steps disagree on which objects are available")
        times = bf16_times[b] = inference_stage_ms(step, model, img, kp3, cam)
        say("bf16", t0, f"b={b}: poses finite, {int(available.sum())} available, the same through the plain versions; "
            f"max|d points| {(coords - coords_p).abs().max().item():.3g} px (rtol 1e-4, atol 5e-3)")
        say("bf16", t0, f"b={b} ms per step, bfloat16 / float32 (phase 6): " + "; ".join(
            f"{k} {v:.3f} / {f32_times[b][k]:.3f}" for k, v in times.items()) + f"; {times['step'] / b:.3f} / "
            f"{f32_times[b]['step'] / b:.3f} ms/image")
    say("bf16", t0, "launches on the bf16 inference path: "
        f"{ {n: kernels[n]['launches_by_path']['inference step bfloat16'] for n in counters} }")
    return bf16_times


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


def drive_eval_path(label, step, planted, kernels, path_kernels, t0, phase="eval", hold_planted=True,
                    plain=("voting", "pnp", "cc")):
    """Drive one eval path and hold its kernels against their plain versions; returns the outputs {b: out}.

    ``planted`` is {b: (batch, planted poses)}. Every kernel count is set to
    0 just before the path runs and read just after, under ``label``; each
    kernel of ``path_kernels`` must have launched. Each launch is recorded
    with its inputs (the wrapper itself still counts it). Then, per batch:
    the whole step again through the plain versions of ``plain`` (voted
    points rtol 1e-4 / atol 5e-3 px, losses rtol 1e-4, gt / missing / false
    positive counts equal), each voting launch against its plain version run in
    float64 (as phase 4), each CC launch against the plain loop (labels
    exactly, sweeps counted), each PnP launch against its plain version on its
    inputs (atol R 1e-4, t 2e-4, as phase 3) and every present object's
    solve against its planted pose (the same atol; with ``hold_planted``
    False only counted: where one voted point lies far from the others'
    cluster, EPnP can start LM in another minimum, in the kernel and its
    plain version alike).
    """
    import torch

    import casapose_tpu_torch.ops.voting as voting
    import casapose_tpu_torch.pose.epnp as epnp
    from casapose_tpu_torch.ops.connected_components import connected_components_kernel
    from casapose_tpu_torch.ops.plain import plain_kernels
    from casapose_tpu_torch.ops.pnp_kernel import solve_pnp_kernel, solve_pnp_plain
    from casapose_tpu_torch.ops.voting_kernel import voting_accumulate, voting_accumulate_plain
    from casapose_tpu_torch.pose.geometry import rodrigues, rotation_to_rvec

    counters = {"voting": voting_accumulate, "pnp": solve_pnp_kernel, "cc": connected_components_kernel}
    recorded = {b: {"voting": [], "pnp": []} for b in planted}
    current = []

    def record_pnp(pts2d, pts3d, K, iterations=10):
        out = solve_pnp_kernel(pts2d, pts3d, K, iterations)
        current[-1]["pnp"].append((pts2d.clone(), pts3d.clone(), K.clone(), iterations) + tuple(x.clone() for x in out))
        return out

    def record_voting(raw, labels, seg_dim, k):
        S = voting_accumulate(raw, labels, seg_dim, k)
        current[-1]["voting"].append((raw, labels.clone(), seg_dim, k, S.clone()))
        return S

    outs = {}
    for fn in counters.values():
        fn.launches = 0
    epnp.solve_pnp_kernel, voting.voting_accumulate = record_pnp, record_voting
    try:
        with cc_recording() as cc_records:
            for b, (batch, _) in planted.items():
                current.append(recorded[b])
                outs[b] = step(batch)
    finally:
        epnp.solve_pnp_kernel, voting.voting_accumulate = solve_pnp_kernel, voting_accumulate
    torch.cuda.synchronize()
    launches = {n: fn.launches for n, fn in counters.items()}
    for name, n in launches.items():
        kernels[name]["launches_by_path"][label] = n
    if any(launches[n] == 0 for n in path_kernels):
        raise AssertionError(f"{label}: a kernel of the path never launched: {launches}")
    if launches["cc"]:
        hold_cc(label, cc_records, kernels, t0, phase)
    for b, out in outs.items():
        batch, truth = planted[b]
        with plain_kernels(*plain):
            plain_out = step(batch)
        for key, v in out.items():
            vals = v if key == "pose_stats" else [v]
            if not all(torch.isfinite(x).all() for x in vals):
                raise AssertionError(f"{label} b={b}: `{key}` is not finite")
        ps, pp = [x.cpu().numpy() for x in out["pose_stats"]], [x.cpu().numpy() for x in plain_out["pose_stats"]]
        torch.testing.assert_close(out["estimated_points"], plain_out["estimated_points"], rtol=1e-4, atol=5e-3)
        # With hold_planted False a row may solve into another minimum in the two runs: the keypoint loss (and the
        # total that holds it) is then reported, the mask, vertex and proxy losses held.
        held_losses = slice(None) if hold_planted else slice(1, 4)
        torch.testing.assert_close(out["losses"][held_losses], plain_out["losses"][held_losses], rtol=1e-4, atol=0.0)
        for i, name in ((2, "gt"), (6, "missing"), (7, "false positive")):
            if not np.array_equal(ps[i], pp[i]):
                raise AssertionError(f"{label} b={b}: {name} counts differ, kernel {ps[i]} plain {pp[i]}")
        # The voting kernel on this path, launch by launch, against float64.
        vote_msg = "no voting launch (not on this path)"
        if recorded[b]["voting"]:
            worst = 0.0
            for raw, lab, seg_dim, k, S in recorded[b]["voting"]:
                err, allowed = voting_vs_float64(S, voting_accumulate_plain(raw.double(), lab, seg_dim, k), seg_dim, k)
                worst = max(worst, (err / allowed).max().item())
                Sp = voting_accumulate_plain(raw, lab, seg_dim, k)
                kernels["voting"]["max_abs_err"] = max(kernels["voting"]["max_abs_err"], (S - Sp).abs().max().item())
            vote_msg = (f"{len(recorded[b]['voting'])} voting launches vs float64: worst |dS| / allowed {worst:.3g}")
        # The PnP kernel on this path, launch by launch: against its plain version on the same inputs, and every
        # present object's row on its planted pose.
        launches_b = recorded[b]["pnp"]
        shapes = [tuple(r[0].shape) for r in launches_b]
        R, t, err = (torch.cat([r[4 + i] for r in launches_b]) for i in range(3))
        Rp, tp, ep = (torch.cat(x) for x in zip(*(solve_pnp_plain(*r[:4]) for r in launches_b)))
        truth = truth.reshape(-1, 3, 4)
        present = truth.abs().sum((1, 2)) > 0
        on_truth = lambda R_, t_: (((R_ - truth[:, :, :3]).abs().amax((1, 2)) <= 1e-4)  # noqa: E731
                                   & ((t_ - truth[:, :, 3]).abs().amax(1) <= 2e-4) & present)
        # Rows held elementwise: all (hold_planted), else those whose plain solve recovers its planted pose; on the
        # others the problem has several minima and the two roundings may stop in different ones (reported).
        held = torch.ones_like(present) if hold_planted else on_truth(Rp, tp)
        if not hold_planted and int(held.sum()) * 2 < int(present.sum()):
            raise AssertionError(f"{label} b={b}: only {int(held.sum())} of {int(present.sum())} planted rows "
                                 "recovered by the plain PnP: the path's problems are not well-posed enough to hold")
        dR, dt = (R - Rp)[held].abs().max().item(), (t - tp)[held].abs().max().item()
        if not (dR <= 1e-4 and dt <= 2e-4):
            raise AssertionError(f"{label} b={b}: PnP kernel disagrees with its plain version on the path's inputs: "
                                 f"|dR| {dR}, |dt| {dt}")
        kernels["pnp"]["max_abs_err"] = max(kernels["pnp"]["max_abs_err"], dR, dt)
        row_dR = (R - truth[:, :, :3]).abs().amax((1, 2))[present]
        row_dt = (t - truth[:, :, 3]).abs().amax(1)[present]
        gt_dR, gt_dt = row_dR.max().item(), row_dt.max().item()
        recovered = int(on_truth(R, t).sum())
        if hold_planted and not (gt_dR <= 1e-4 and gt_dt <= 2e-4):
            raise AssertionError(f"{label} b={b}: PnP kernel missed planted poses: |dR| {gt_dR}, |dt| {gt_dt}")
        # What the step makes of the solve: R -> rvec (the p6d output) -> R, which amplifies rounding near 180 deg.
        trip = (rodrigues(rotation_to_rvec(R)) - rodrigues(rotation_to_rvec(Rp))).abs().amax((1, 2))
        d_trip, worst_row = trip.max().item(), int(trip.argmax())
        trip_deg = np.degrees(np.arccos(np.clip((R[worst_row].trace().item() - 1.0) / 2.0, -1.0, 1.0)))
        losses = out["losses"].cpu().numpy()
        say(phase, t0, f"{label} b={b}: outputs finite; max|d points| "
            f"{(out['estimated_points'] - plain_out['estimated_points']).abs().max().item():.3g} px (rtol 1e-4, atol 5e-3); "
            f"losses {np.array2string(losses, precision=6)}, max rel diff "
            f"{((out['losses'] - plain_out['losses']).abs() / plain_out['losses'].abs().clamp(min=1e-30)).max().item():.3g} "
            f"(rtol 1e-4); gt {ps[2].sum():.0f}, missing {ps[6].sum():.0f}, false positive {ps[7].sum():.0f} (equal); "
            f"{vote_msg}; PnP launches {shapes}: kernel vs plain on {int(held.sum())} of {R.shape[0]} rows max|dR| "
            f"{dR:.3g} max|dt| {dt:.3g} (atol R 1e-4, t 2e-4), planted poses recovered on {recovered} of "
            f"{int(present.sum())} rows (plain {int(on_truth(Rp, tp).sum())}), max|dR| {gt_dR:.3g} "
            f"max|dt| {gt_dt:.3g}, max err kernel "
            f"{err.max().item():.3g} plain {ep.max().item():.3g}; after R -> rvec -> R max|dR| {d_trip:.3g} (rotation "
            f"{trip_deg:.4f} deg); valid 2D {ps[0].sum():.0f}/{pp[0].sum():.0f}, 3D {ps[1].sum():.0f}/{pp[1].sum():.0f}; "
            f"error sums 2D {ps[4].sum():.6g}/{pp[4].sum():.6g} px, 3D {ps[5].sum():.6g}/{pp[5].sum():.6g} m "
            f"(kernel/plain, reported)")
    say(phase, t0, f"launches on the path `{label}`: {launches}")
    return outs


def phase_eval(dev, kernels):
    """8. The evaluation step at full width, kernels against plain versions; launches counted per path."""
    import torch

    from casapose_tpu_torch.eval import build_test_step, loss_weights_from_opt
    from casapose_tpu_torch.models.registry import get_model

    t0 = time.time()
    opt = eval_opt(EVAL_CHUNK)
    model = get_model("casapose_c_gcu5", ver_dim=3 * K_POINTS, seg_dim=SEG_DIM, device=dev,
                      generator=torch.Generator().manual_seed(0))
    verts, counts = eval_meshes()
    step = build_test_step(model, opt, OBJECTS, verts, counts, loss_weights_from_opt(opt))
    planted = {b: planted_eval_batch(model, opt, b, seed=b, dev=dev) for b in (1, 32)}
    drive_eval_path("eval step", step, planted, kernels, ("voting", "pnp", "cc"), t0)
    return model, step, {b: batch for b, (batch, _) in planted.items()}


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
    from casapose_tpu_torch.pose.metrics import symmetric_objects

    t0 = time.time()
    opt = eval_opt(EVAL_CHUNK)
    sym = symmetric_objects(eval_meshes()[1])  # as build_test_step hands them to the step
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
                    evaluation_points=verts, object_points_3d_count=counts, min_num=1, symmetric_objects=sym), 3),
                # The metrics' split: ADD and 2D on every row, without the symmetric objects' ADD-S.
                "metrics ADD/2D only": cuda_ms(lambda: evaluate_pose_estimates(
                    points_est, poses_est, c["poses_gt"], tseg, c["keypoints3d"], c["camera"], c["diameters"],
                    evaluation_points=verts, object_points_3d_count=counts, min_num=1, symmetric_objects=()), 3),
                "losses (direction fields, composite, proxy)": cuda_ms(losses, 3),
            }
        say("time", t0, f"eval stages on {n} image(s), ms/image: "
            + "; ".join(f"{k} {v / n:.3f}" for k, v in stages.items())
            + f"; so ADD-S on the {len(sym)} symmetric objects' rows (V = 7862 and 3417) "
            f"{(stages['metrics (ADD(-S)/2D)'] - stages['metrics ADD/2D only']) / n:.3f}")

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


TRAIN_SIZE = 448  # configs/config_8.ini: 448x448 crops of the 480x640 scenes
TRAIN_STEPS = 30
# Phase 16: each object is SCATTER_PX pixels scattered over the image, so its votes spread over 28-99 px, and the
# camera has a 128-px focal length (as phase 13's). On the CPU at 448x448 the plain PnP then finds all 32 planted
# poses, and the implicit-function VJP moves by 9e-5 of its max for a 1e-6 change of the pose (3e-4 through 572 px).
SCATTER_PX = 60  # over 50, so that every object passes the keypoint loss's pixel-count filter
SHORT_FOCAL = 128.0


def count_launches():
    """The four kernel wrappers, whose ``launches`` counts every launch of their kernel."""
    from casapose_tpu_torch.ops.connected_components import connected_components_kernel
    from casapose_tpu_torch.ops.pnp_kernel import lm_refine, solve_pnp_kernel
    from casapose_tpu_torch.ops.voting_kernel import voting_accumulate

    return {"voting": voting_accumulate, "pnp": solve_pnp_kernel, "lm_refine": lm_refine,
            "cc": connected_components_kernel}


def train_batch(b, seed, size=None, scatter=0, focal=572.0):
    """A training batch in the loader's format (__graft_entry__.py::make_synthetic_batch, copied: random dense
    labels). With ``scatter`` each of the 8 objects is instead that many pixels scattered over the whole image: the
    random network's votes for an object's keypoints then spread over tens of pixels (within 1-3 px of each other on
    dense labels or compact blocks), and PnP problems planted on them are well-conditioned."""
    size = size or TRAIN_SIZE
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, OBJECTS + 1, (b, size, size, 1)).astype(np.uint8)
    if scatter:
        labels[:] = 0
        for i in range(b):
            flat = rng.choice(size * size, OBJECTS * scatter, replace=False)
            labels[i, flat // size, flat % size, 0] = np.repeat(np.arange(1, OBJECTS + 1), scatter)
    f32 = lambda a: np.ascontiguousarray(a, np.float32)  # noqa: E731
    return {
        "img": rng.integers(0, 255, (b, size, size, 3)).astype(np.uint8),
        "seg": labels,
        "keypoints2d": f32(rng.uniform(0, size, (b, OBJECTS, 1, K_POINTS, 2))),
        "keypoints3d": f32(rng.uniform(-0.05, 0.05, (b, OBJECTS, 1, K_POINTS, 3))),
        "camera": f32(np.tile(np.array([[focal, 0, size / 2], [0, focal, size / 2], [0, 0, 1]]), (b, 1, 1))),
        "diameters": f32(np.full((b, OBJECTS, 1, 1), 0.1)),
        "offsets": f32(np.tile(np.array([0, 0, size, size, 0, 0, 0, 1.0, size, size]), (b, 1))),
        "cuboid3d": f32(np.zeros((b, OBJECTS, 1, 8, 3))),
        "poses_gt": f32(np.tile(np.concatenate([np.eye(3), [[0], [0], [0.8]]], axis=1), (b, OBJECTS, 1, 1, 1))),
        "pixel_gt_count": f32(np.full((b, OBJECTS, 1, 1), 100)),
    }


def train_opt(*flags):
    """The flagship training config (configs/config_8.ini) with any further flags."""
    from casapose_tpu_torch.utils.config import parse_config

    return parse_config(["-c", os.path.join(ROOT, "configs", "config_8.ini"), "--objects_to_copy_list", "",
                         "--outf", "chip_smoke/unused", *flags])


def train_setup(opt, dev, dtype="float32", seed=0, batches=1000):
    """(model, AdamTF, StepConfig, LossWeights) as run_training builds them for ``opt``, weights from ``seed``."""
    import torch

    from casapose_tpu_torch.core.optimizer import AdamTF
    from casapose_tpu_torch.losses.schedules import LossWeightHandler, make_lr_schedule
    from casapose_tpu_torch.models.registry import get_model
    from casapose_tpu_torch.train import step_config_from_opt

    model = get_model("casapose_c_gcu5", ver_dim=3 * K_POINTS, seg_dim=SEG_DIM, device=dev, dtype=dtype,
                      generator=torch.Generator().manual_seed(seed))
    optimizer = AdamTF(model.parameters(), make_lr_schedule(opt.lr, opt.lr_decay, opt.lr_epochs, opt.lr_epochs_start,
                                                            opt.lr_epochs_steps, batches))
    lw = LossWeightHandler(mask_loss_weight=opt.mask_loss_weight, vertex_loss_weight=opt.vertex_loss_weight,
                           proxy_loss_weight=opt.proxy_loss_weight, kp_loss_weight=opt.keypoint_loss_weight,
                           filter_vertex_with_segmentation=opt.filter_vertex_with_segmentation,
                           filter_high_proxy_errors=opt.filter_high_proxy_errors).as_loss_weights()
    return model, optimizer, step_config_from_opt(opt, OBJECTS), lw


def profile_step(fn, iters, top=8):
    """torch.profiler over ``iters`` calls of ``fn()`` after one warm-up call: (device-busy ms per call from the
    kernels' times, wall ms per call, the ``top`` kernels and the ``top`` operators by device time per call, each
    as (name, ms, launches per call))."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t = time.time()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    wall = (time.time() - t) * 1e3 / iters
    dev_time = lambda e: getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))  # noqa: E731
    events = [e for e in prof.key_averages() if dev_time(e) > 0]
    on_device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    ops = [e for e in events if e.device_type != torch.autograd.DeviceType.CUDA]
    busy = sum(dev_time(e) for e in on_device) / 1e3 / iters
    rank = lambda es: [(e.key[:60], dev_time(e) / 1e3 / iters, e.count // iters)  # noqa: E731
                       for e in sorted(es, key=dev_time, reverse=True)[:top]]
    return busy, wall, rank(on_device), rank(ops)


def train_step_split_ms(model, optimizer, cfg, lw, batch, gen, n, precision="highest"):
    """ms of forward (+ losses and BatchNorm statistics), backward and optimizer, CUDA events around each part of
    ``n`` steps run as build_train_step runs them (at ``precision``, --matmul_precision)."""
    import torch

    from casapose_tpu_torch.core.numerics import matmul_precision
    from casapose_tpu_torch.train import forward_and_loss

    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(4)] for _ in range(n)]
    for e in ev:
        e[0].record()
        optimizer.zero_grad(set_to_none=True)
        with matmul_precision(precision):
            losses, _ = forward_and_loss(model, batch, cfg, lw, train=True, generator=gen)
            e[1].record()
            losses[0].backward()
            e[2].record()
            optimizer.step()
        e[3].record()
    torch.cuda.synchronize()
    parts = np.array([[e[i].elapsed_time(e[i + 1]) for i in range(3)] for e in ev])
    return dict(zip(("forward", "backward", "optimizer"), parts.mean(0)))


def phase_train_steps(dev, kernels):
    """15. The config_8 train step at full width: float32 batch 4, bf16 batch 8 (the JAX bench's shape) and float32
    batch 8 (the bf16 run's yardstick), TRAIN_STEPS steps each on one seeded batch."""
    import torch

    from casapose_tpu_torch.train import build_train_step, device_batch

    t0 = time.time()
    opt = train_opt()
    counters = count_launches()
    results = {}
    for label, dtype, b in (("train step f32 b4", "float32", 4), ("train step bf16 b8", "bfloat16", 8),
                            ("train step f32 b8", "float32", 8)):
        model, optimizer, cfg, lw = train_setup(opt, dev, dtype)
        step = build_train_step(model, optimizer, cfg, lw)
        batch = device_batch(train_batch(b, seed=0), dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        losses = torch.stack([step(batch, gen) for _ in range(TRAIN_STEPS)]).cpu().numpy()
        for name, fn in counters.items():
            kernels[name]["launches_by_path"][label] = fn.launches
        peak = torch.cuda.max_memory_allocated()
        bad = [n for n, p in model.named_parameters() if p.grad is not None and not torch.isfinite(p.grad).all()]
        if bad or not np.isfinite(losses).all():
            raise AssertionError(f"{label}: non-finite gradients {bad[:5]} or losses {losses[~np.isfinite(losses)]}")
        if not losses[-1, 0] < losses[0, 0]:
            raise AssertionError(f"{label}: the total loss did not fall over {TRAIN_STEPS} steps: {losses[:, 0]}")
        step_ms = cuda_ms(lambda: step(batch, gen), 10, warmup=0)
        split = train_step_split_ms(model, optimizer, cfg, lw, batch, gen, 5)
        if label != "train step f32 b8":
            busy, wall, top_kernels, top_ops = profile_step(lambda: step(batch, gen), 3)
            say("train", t0, f"{label} under torch.profiler: device busy {busy:.3f} of {wall:.3f} ms per step "
                f"({1 - busy / wall:.1%} idle); top kernels (ms per step, launches): "
                + "; ".join(f"{k} {ms:.3f} x{n}" for k, ms, n in top_kernels) + "; top operators by the device "
                "time of the kernels they launch: " + "; ".join(f"{k} {ms:.3f} x{n}" for k, ms, n in top_ops))
        results[label] = {"losses": losses, "step_ms": step_ms}
        say("train", t0, f"{label} ({TRAIN_SIZE}x{TRAIN_SIZE}, config_8): total loss {losses[0, 0]:.5f} -> "
            f"{losses[-1, 0]:.5f} over {TRAIN_STEPS} steps (mask {losses[0, 1]:.4f} -> {losses[-1, 1]:.4f}, vertex "
            f"{losses[0, 2]:.4f} -> {losses[-1, 2]:.4f}, proxy {losses[0, 3]:.4f} -> {losses[-1, 3]:.4f}, keypoint "
            f"{losses[0, 4]:.4f} -> {losses[-1, 4]:.4f}); gradients finite; step {step_ms:.3f} ms, "
            f"{step_ms / b:.3f} ms/image; split " + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items())
            + f"; peak memory {peak / 2**30:.2f} GiB ({(peak - base) / 2**30:.2f} above model + batch); "
            f"launches {dict((n, fn.launches) for n, fn in counters.items())}")
        del model, optimizer, step, batch
        torch.cuda.empty_cache()
    # bf16 against its own float32 run at the same batch: the first step's total loss within 3% (the same weights,
    # one batch), the mean of the last 5 within 15% (30 Adam steps apart in two roundings).
    lb, lf = results["train step bf16 b8"]["losses"][:, 0], results["train step f32 b8"]["losses"][:, 0]
    first, last = abs(lb[0] - lf[0]) / lf[0], abs(lb[-5:].mean() - lf[-5:].mean()) / lf[-5:].mean()
    if not (first <= 0.03 and last <= 0.15):
        raise AssertionError(f"bf16 loss left its band around the float32 run: first step {first:.3%}, last 5 {last:.3%}")
    say("train", t0, f"bf16 b8 against f32 b8: first-step total loss {lb[0]:.5f} / {lf[0]:.5f} ({first:.3%}, band 3%), "
        f"mean of the last 5 {lb[-5:].mean():.5f} / {lf[-5:].mean():.5f} ({last:.3%}, band 15%); per image bf16 "
        f"{results['train step bf16 b8']['step_ms'] / 8:.3f} ms, f32 {results['train step f32 b8']['step_ms'] / 8:.3f} ms")
    return {label: r["step_ms"] for label, r in results.items()}


def plant_train_keypoints(batch, coords, seed=5, noise_px=0.0, depth=(0.75, 0.85)):
    """tests/torch_parity.py::plant_train_keypoints: each object's model keypoints where a random pose projects them
    within N(0, noise_px) pixels of its voted points [b, oc, k, 2] (y, x), through the batch's camera. Phase 16
    plants exactly (the default), so that a solve that finds the planted pose has found the minimum; the CPU tests
    add 0.05 px, for a reprojection residual above rounding. Returns (batch, planted poses [b * oc, 3, 4])."""
    rng = np.random.default_rng(seed)
    b = coords.shape[0]
    n = b * OBJECTS
    K = batch["camera"][0].astype(np.float64)
    R = random_rotations(rng, n)
    t = np.stack([rng.uniform(-0.05, 0.05, n), rng.uniform(-0.05, 0.05, n), rng.uniform(0.75, 0.85, n)], 1)
    xy = coords.reshape(n, K_POINTS, 2)[..., ::-1].astype(np.float64) + rng.normal(0.0, noise_px, (n, K_POINTS, 2))
    cam_pts = (np.concatenate([xy, np.ones((n, K_POINTS, 1))], -1) @ np.linalg.inv(K).T) * rng.uniform(
        *depth, (n, K_POINTS, 1))
    model_pts = np.einsum("bji,bnj->bni", R, cam_pts - t[:, None])
    t_gt = t + [0.06, -0.04, 0.08]
    uvw = (np.einsum("nij,nkj->nki", R, model_pts) + t_gt[:, None]) @ K.T
    out = dict(batch)
    out["keypoints3d"] = model_pts.reshape(b, OBJECTS, 1, K_POINTS, 3).astype(np.float32)
    out["poses_gt"] = np.concatenate([R, t_gt[:, :, None]], -1).reshape(b, OBJECTS, 1, 3, 4).astype(np.float32)
    out["keypoints2d"] = (uvw[..., :2] / uvw[..., 2:])[..., ::-1].reshape(b, OBJECTS, 1, K_POINTS, 2).astype(np.float32)
    return out, np.concatenate([R, t[:, :, None]], -1).astype(np.float32)


def phase_bpnp(dev, kernels):
    """16. The BPnP train step (use_bpnp_reprojection_loss 1) at B = 32 on planted problems: each PnP launch against
    its plain version, the BPnP input gradients against the plain PnP's, the backward timed."""
    import torch

    import casapose_tpu_torch.losses.losses as losses_mod
    import casapose_tpu_torch.pose.epnp as epnp
    from casapose_tpu_torch.core.numerics import f32_precision
    from casapose_tpu_torch.data.pipeline import prepare_device_batch
    from casapose_tpu_torch.ops.plain import plain_kernels
    from casapose_tpu_torch.ops.pnp_kernel import solve_pnp_kernel, solve_pnp_plain
    from casapose_tpu_torch.ops.voting import ls_voting
    from casapose_tpu_torch.pose.bpnp import bpnp_pose, ift_vjp
    from casapose_tpu_torch.train import build_train_step, device_batch, forward_and_loss

    t0 = time.time()
    opt = train_opt("--use_bpnp_reprojection_loss", "1")
    model, optimizer, cfg, lw = train_setup(opt, dev)
    host = train_batch(4, seed=1, scatter=SCATTER_PX, focal=SHORT_FOCAL)
    batch = device_batch(host, dev)
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad(), f32_precision():  # the points the train step votes (batch-statistics BatchNorm)
        model.train()
        img, tseg = prepare_device_batch(batch["img"], batch["seg"], SEG_DIM)
        out = model(img, tseg)
        coords = ls_voting(tseg, out[..., SEG_DIM : SEG_DIM + 2 * K_POINTS], out[..., SEG_DIM + 2 * K_POINTS :],
                           num_points=K_POINTS).double().cpu().numpy()
    model.load_state_dict(initial)  # undo that pass's running-statistics update
    host, truth = plant_train_keypoints(host, coords)
    batch = device_batch(host, dev)
    truth = torch.from_numpy(truth).to(dev)
    spread = coords.reshape(-1, K_POINTS, 2).std(axis=1).max(axis=1)  # px, per object

    pnp_calls, bpnp_calls = [], []

    def record_pnp(pts2d, pts3d, K, iterations=10):
        out = solve_pnp_kernel(pts2d, pts3d, K, iterations)
        pnp_calls.append((pts2d.clone(), pts3d.clone(), K.clone(), iterations) + tuple(x.clone() for x in out))
        return out

    def record_bpnp(pts2d, pts3d, K):
        bpnp_calls.append((pts2d.detach().clone(), pts3d.detach().clone(), K.detach().clone()))
        return bpnp_pose(pts2d, pts3d, K)

    # The step's losses, BPnP forward through the kernel and through its plain version, before any update moves the
    # votes away from the planted problems: the mask, vertex and proxy losses held (rtol 1e-4), the keypoint loss
    # (and the total that holds it) reported: it measures the two solves' poses in pixels, which are held row by row
    # below at the PnP tolerances (a 1e-6 rotation difference moves its pixels by ~1e-4 relative).
    with torch.no_grad(), f32_precision():
        fwd_losses = torch.stack(forward_and_loss(model, batch, cfg, lw, train=True)[0]).cpu().numpy()
        with plain_kernels("pnp"):
            fwd_plain = torch.stack(forward_and_loss(model, batch, cfg, lw, train=True)[0]).cpu().numpy()
    np.testing.assert_allclose(fwd_losses[1:4], fwd_plain[1:4], rtol=1e-4, atol=0.0, err_msg="bpnp train-step losses")
    model.load_state_dict(initial)

    counters = count_launches()
    step = build_train_step(model, optimizer, cfg, lw)
    gen = torch.Generator(device=dev).manual_seed(0)
    for fn in counters.values():
        fn.launches = 0
    epnp.solve_pnp_kernel, losses_mod.bpnp_pose = record_pnp, record_bpnp
    try:  # one step without noise: its votes are the planted ones
        losses = step(batch).cpu().numpy()
    finally:
        epnp.solve_pnp_kernel, losses_mod.bpnp_pose = solve_pnp_kernel, bpnp_pose
    torch.cuda.synchronize()
    for name, fn in counters.items():
        kernels[name]["launches_by_path"]["bpnp train step"] = fn.launches
    if counters["pnp"].launches == 0 or not bpnp_calls:
        raise AssertionError(f"bpnp train step: the PnP kernel never launched: {counters['pnp'].launches}")
    if not np.isfinite(losses).all() or any(p.grad is not None and not torch.isfinite(p.grad).all()
                                            for p in model.parameters()):
        raise AssertionError(f"bpnp train step: non-finite losses {losses} or gradients")
    # Each PnP launch against its plain version on the same inputs (atol R 1e-4, t 2e-4, as phase 3), on the rows
    # whose plain solve finds the planted pose (at least half of them); the kernel's own recoveries are counted.
    R, t = (torch.cat([c[4 + i] for c in pnp_calls]) for i in range(2))
    Rp, tp = (torch.cat(x) for x in list(zip(*(solve_pnp_plain(*c[:4]) for c in pnp_calls)))[:2])
    truth_all = truth.repeat(len(pnp_calls), 1, 1)
    on_truth = lambda R_, t_: (((R_ - truth_all[:, :, :3]).abs().amax((1, 2)) <= 1e-4)  # noqa: E731
                               & ((t_ - truth_all[:, :, 3]).abs().amax(1) <= 2e-4))
    held = on_truth(Rp, tp)
    if int(held.sum()) * 2 < held.numel():
        raise AssertionError(f"bpnp train step: the plain PnP found only {int(held.sum())} of {held.numel()} planted "
                             "poses: the problems are not well-posed enough to hold")
    dR, dt = (R - Rp)[held].abs().max().item(), (t - tp)[held].abs().max().item()
    if not (dR <= 1e-4 and dt <= 2e-4):
        raise AssertionError(f"bpnp train step: PnP kernel disagrees with its plain version: |dR| {dR}, |dt| {dt}")
    kernels["pnp"]["max_abs_err"] = max(kernels["pnp"]["max_abs_err"], dR, dt)
    # The BPnP input gradients (the implicit-function VJP) at the kernel's solutions against those at the plain
    # version's, for one seeded upstream gradient, rtol 1e-3 of each part's max, on the held rows whose rotation is
    # under 172 degrees: the VJP is taken at p6d = [rvec | t], and the reference's R -> rvec conversion turns solves
    # 1e-6 apart into rvecs far apart near 180 degrees (ROADMAP.md section 3).
    x, z, K = bpnp_calls[0]
    g = torch.from_numpy(np.random.default_rng(2).normal(size=(x.shape[0], 6)).astype(np.float32)).to(dev)
    with torch.no_grad(), f32_precision():
        p6d = bpnp_pose(x, z, K)
        with plain_kernels("pnp"):
            p6d_plain = bpnp_pose(x, z, K)
        trace = truth[:, 0, 0] + truth[:, 1, 1] + truth[:, 2, 2]
        angle = torch.arccos(torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0))
        held0 = held[: x.shape[0]] & (angle < np.radians(172.0))
        worst = worst_all = 0.0
        for gk, gp in zip(ift_vjp(g, p6d, x, z, K), ift_vjp(g, p6d_plain, x, z, K)):
            rel = lambda rows: ((gk - gp)[rows].abs().max() / gp[rows].abs().max().clamp(min=1e-30)).item()  # noqa: E731
            worst, worst_all = max(worst, rel(held0)), max(worst_all, rel(held[: x.shape[0]]))
        dp6d = (p6d - p6d_plain)[held0].abs().max().item()
    if worst > 1e-3:
        raise AssertionError(f"bpnp: input gradients at the kernel's solutions differ from the plain version's by {worst} "
                             f"(max |d p6d| {dp6d:.3g} there; {worst_all:.3g} on every held row)")
    with f32_precision():
        bwd_ms = cuda_ms(lambda: ift_vjp(g, p6d, x, z, K), 10)
    step_ms = cuda_ms(lambda: step(batch, gen), 5)
    if any(p.grad is not None and not torch.isfinite(p.grad).all() for p in model.parameters()):
        raise AssertionError("bpnp train step: non-finite gradients in the timed steps")
    kp_apart = abs(fwd_losses[4] - fwd_plain[4]) / fwd_plain[4]
    say("bpnp", t0, f"B={x.shape[0]} (batch 4 x {OBJECTS} objects, {TRAIN_SIZE}x{TRAIN_SIZE}, {SHORT_FOCAL:.0f}-px "
        f"focal, {SCATTER_PX} scattered pixels per object; the voted keypoints spread {spread.min():.2f}-"
        f"{spread.max():.2f} px): one step, losses finite {np.array2string(losses, precision=5)}; "
        f"{len(pnp_calls)} PnP launches {[tuple(c[0].shape) for c in pnp_calls]}: planted poses found by the plain "
        f"version on {int(held.sum())} of {held.numel()} rows, by the kernel on {int(on_truth(R, t).sum())}; kernel vs "
        f"plain there max|dR| {dR:.3g} max|dt| {dt:.3g} (atol R 1e-4, t 2e-4); BPnP input gradients kernel vs plain "
        f"{worst:.3g} of max (rtol 1e-3) on the {int(held0.sum())} held rows under 172 degrees (max |d p6d| "
        f"{dp6d:.3g}; {worst_all:.3g} on every held row); train-step losses kernel "
        f"{np.array2string(fwd_losses, precision=6)} plain {np.array2string(fwd_plain, precision=6)} (mask, vertex, "
        f"proxy rtol 1e-4; the keypoint loss, which turns pose differences of the held size into pixels, "
        f"{kp_apart:.3g} apart); BPnP backward (implicit-function VJP, torch.func) {bwd_ms:.3f} ms; "
        f"BPnP train step {step_ms:.3f} ms; launches {dict((n, fn.launches) for n, fn in counters.items())}")


def phase_train_harness(dev, kernels):
    """17. run_training on a written 480x640 scene (448x448 crops, config_8): 2 epochs with pose validation and a
    checkpoint each, then a resume for a third."""
    import contextlib
    import io

    import torch

    from casapose_tpu_torch.train import run_training

    t0 = time.time()
    counters = count_launches()
    with tempfile.TemporaryDirectory() as tmp:
        names = write_scene(tmp, n_images=40)
        say("train harness", t0, f"wrote 40 images of {H}x{W} with {OBJECTS} objects")
        flags = ["--data", os.path.join(tmp, "data"), "--datatest", os.path.join(tmp, "data"),
                 "--datameshes", os.path.join(tmp, "models"), "--object", ",".join(names), "--saveinterval", "1",
                 "--validationinterval", "1", "--loginterval", "3", "--workers", "4", "--manualseed", "1",
                 "--pretrained", "0"]
        for fn in counters.values():
            fn.launches = 0
        lines = []
        for epochs in (2, 3):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                state = run_training(train_opt(*flags, "--epochs", str(epochs), "--outf", os.path.join(tmp, "out")),
                                     device=str(dev))
            out = buf.getvalue()
            print(out, end="", flush=True)
            lines.append(out)
        torch.cuda.synchronize()
        for name, fn in counters.items():
            kernels[name]["launches_by_path"]["train harness"] = fn.launches
        if counters["pnp"].launches == 0:
            raise AssertionError("train harness: the PnP kernel never launched (pose validation)")
        if "restored checkpoint at epoch 2" not in lines[1] or "Finished epoch 3" not in lines[1]:
            raise AssertionError("train harness: the second run did not resume from step_2")
        ckpt = sorted(os.listdir(os.path.join(tmp, "out", "training_checkpoints")))
        with open(os.path.join(tmp, "out", "test_summary.csv")) as f:
            summary = f.read().strip().splitlines()
        values = [float(x) for x in summary[-1].split(",")[2:]]
        if ckpt != ["step_1", "step_2", "step_3"] or not np.isfinite(values).all() or state.step <= 0:
            raise AssertionError(f"train harness: checkpoints {ckpt}, last test summary {summary[-1]}")
        keep = [ln for ln in "".join(lines).splitlines() if ln.startswith(("train:", "== TRAINING", "== VALIDATION",
                                                                           "restored"))]
        say("train harness", t0, "2 epochs + a resumed third, pose validation each epoch, checkpoints "
            f"{ckpt}, {state.step} optimizer steps after the resume; launches "
            f"{dict((n, fn.launches) for n, fn in counters.items())}; " + " | ".join(keep))


# Phases 18-21: the options of the harnesses (--matmul_precision, --remat, data parallelism, the harness options).


def op_device_ms(fn, iters, name):
    """Device ms per ``fn()`` of the kernels that operator ``name`` launches (torch.profiler, after a warm-up)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    dev_time = lambda e: getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))  # noqa: E731
    return sum(dev_time(e) for e in prof.key_averages()
               if e.key == name and e.device_type != torch.autograd.DeviceType.CUDA) / 1e3 / iters


def one_train_step(opt, dev, host, seed=0, data_parallel=None, **cfg_changes):
    """One config_8 train step from the weights of ``seed`` on the host batch ``host``: (losses, state after the step,
    gradients, (model, optimizer, cfg, lw, step, batch, generator)) for timing."""
    import dataclasses

    import torch

    from casapose_tpu_torch.train import build_train_step, device_batch

    model, optimizer, cfg, lw = train_setup(opt, dev, seed=seed)
    cfg = dataclasses.replace(cfg, **cfg_changes)
    step = build_train_step(model, optimizer, cfg, lw, data_parallel=data_parallel)
    batch = device_batch(host, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    losses = step(batch, gen).cpu().numpy()
    state = {k: v.detach().cpu().clone().numpy() for k, v in model.state_dict().items()}
    grads = {n: p.grad.detach().cpu().clone().numpy() for n, p in model.named_parameters()}
    return losses, state, grads, (model, optimizer, cfg, lw, step, batch, gen)


def compare_train_steps(label, ref, got, lr, rtol=1e-5, atol=1e-6, grad_tol=1e-4):
    """Hold one train step (losses, state after it, gradients) against another: the losses and the running statistics
    at rtol/atol (tests/test_remat.py's 1e-5 / 1e-6), each gradient within grad_tol of its tensor's max, and each
    weight within what the first AdamTF update, u(g) = -lr g / (|g| + eps / sqrt(1 - b2)), makes of that gradient
    agreement plus float32 rounding (4 ulps of lr, 2 of the weight). The bilinear upsampling's backward accumulates
    with atomics on the card (no deterministic implementation), so gradients differ in their last bits between any
    two runs, and the first Adam step moves a weight whose gradient is near zero by up to 2 lr whichever way its sign
    falls: weights are held through that map, not at rtol 1e-5. Returns a summary dict."""
    (l_ref, s_ref, g_ref), (l_got, s_got, g_got) = ref, got
    np.testing.assert_allclose(l_got, l_ref, rtol=rtol, atol=atol, err_msg=f"{label}: losses")
    grad_err, plain_misses = 0.0, 0
    for name, ref_v in s_ref.items():
        v = s_got[name]
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v, ref_v, rtol=rtol, atol=atol, err_msg=f"{label}: {name}")
            continue
        g = g_ref[name].astype(np.float64)
        scale = max(np.abs(g).max(), 1e-30)
        grad_err = max(grad_err, float(np.abs(g_got[name] - g).max() / scale))
        delta = grad_tol * scale
        u = lambda x: -lr * x / (np.abs(x) + 1e-7 / np.sqrt(1.0 - 0.999))  # noqa: E731
        bound = (np.maximum(np.abs(u(g + delta) - u(g)), np.abs(u(g - delta) - u(g))) + 4 * np.spacing(np.float32(lr))
                 + 2 * np.spacing(np.abs(ref_v)))
        if not np.all(np.abs(v - ref_v) <= bound):
            raise AssertionError(f"{label}: {name} moved apart by {np.abs(v - ref_v).max():.3g}, beyond the AdamTF map "
                                 "of the gradients' agreement")
        plain_misses += int(np.sum(np.abs(v - ref_v) > atol + rtol * np.abs(ref_v)))
    if grad_err > grad_tol:
        raise AssertionError(f"{label}: gradients {grad_err:.3g} of their max apart (tolerance {grad_tol})")
    return {"loss_err": float(np.max(np.abs(l_got - l_ref) / np.maximum(np.abs(l_ref), 1e-30))), "grad_err": grad_err,
            "weights_beyond_rtol": plain_misses}


def phase_precision(dev, kernels):
    """18. --matmul_precision: the config_8 train step (float32 batch 4, phase 15's setup) and the float32 inference
    step at batch 32, each at highest (TF32 off) and high (TF32 in cuBLAS and cuDNN)."""
    import torch

    from casapose_tpu_torch.core.numerics import matmul_precision
    from casapose_tpu_torch.entry import build_inference_step

    t0 = time.time()
    opt = train_opt()
    counters = count_launches()
    host = train_batch(4, seed=0)
    runs = {}
    for precision in ("highest", "high"):
        label = f"train step f32 b4 {precision}"
        for fn in counters.values():
            fn.launches = 0
        first, _, _, (model, optimizer, cfg, lw, step, batch, gen) = one_train_step(opt, dev, host,
                                                                                   matmul_precision=precision)
        losses = np.stack([first] + [step(batch, gen).cpu().numpy() for _ in range(TRAIN_STEPS - 1)])
        torch.cuda.synchronize()
        for name, fn in counters.items():
            kernels[name]["launches_by_path"][label] = fn.launches
        step_ms = cuda_ms(lambda: step(batch, gen), 10, warmup=0)
        split = train_step_split_ms(model, optimizer, cfg, lw, batch, gen, 5, precision=precision)
        bmm = op_device_ms(lambda: step(batch, gen), 3, "aten::bmm")
        runs[precision] = {"losses": losses, "step_ms": step_ms}
        if not np.isfinite(losses).all() or not losses[-1, 0] < losses[0, 0]:
            raise AssertionError(f"{label}: non-finite losses, or the total loss did not fall: {losses[:, 0]}")
        say("precision", t0, f"{label}: step {step_ms:.3f} ms ({step_ms / 4:.3f} ms/image); split "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items()) + f"; aten::bmm {bmm:.3f} ms of device time per "
            f"step; total loss {losses[0, 0]:.5f} -> {losses[-1, 0]:.5f} over {TRAIN_STEPS} steps")
        del model, optimizer, step, batch
        torch.cuda.empty_cache()
    # TF32 against float32 on the same weights and batch. The first step's total loss within 1e-3 (about TF32's
    # epsilon, 2^-10; the card read 5e-5 in two runs) and the mean of the last 5 of 30 steps within 1% (the card
    # read 0.066% and 0.182%: the trajectories part slowly, and the bilinear backward's atomics make each run's
    # own). A TF32 path that computed another network would leave both.
    hi, tf = runs["highest"]["losses"][:, 0], runs["high"]["losses"][:, 0]
    first, last = abs(tf[0] - hi[0]) / hi[0], abs(tf[-5:].mean() - hi[-5:].mean()) / hi[-5:].mean()
    if not (first <= 1e-3 and last <= 1e-2):
        raise AssertionError(f"TF32 loss left its band around float32's: first step {first:.3%}, last 5 {last:.3%}")
    say("precision", t0, f"high against highest, train step f32 b4: first-step total loss {tf[0]:.5f} / {hi[0]:.5f} "
        f"({first:.3%}, band 0.1%), mean of the last 5 {tf[-5:].mean():.5f} / {hi[-5:].mean():.5f} ({last:.3%}, band "
        f"1%); step {runs['high']['step_ms']:.3f} / {runs['highest']['step_ms']:.3f} ms "
        f"({runs['highest']['step_ms'] / runs['high']['step_ms']:.3f}x)")

    rng = np.random.default_rng(0)
    b = 32
    img = torch.from_numpy(rng.normal(size=(b, H, W, 3)).astype(np.float32)).to(dev)
    kp3 = torch.from_numpy(rng.uniform(-0.05, 0.05, (b, OBJECTS, 1, K_POINTS, 3)).astype(np.float32)).to(dev)
    cam = torch.tensor(CAMERA, device=dev).expand(b, 3, 3).contiguous()
    points, outputs = {}, {}
    for precision in ("highest", "high"):
        label = f"inference step f32 b32 {precision}"
        step, model = build_inference_step(OBJECTS, K_POINTS, H, W, device="cuda", precision=precision,
                                           generator=torch.Generator().manual_seed(0))
        for fn in counters.values():
            fn.launches = 0
        poses, points[precision] = step(img, kp3, cam, return_points=True)
        torch.cuda.synchronize()
        for name, fn in counters.items():
            kernels[name]["launches_by_path"][label] = fn.launches
        if counters["voting"].launches == 0 or counters["pnp"].launches == 0 or not torch.isfinite(poses).all():
            raise AssertionError(f"{label}: launches {[fn.launches for fn in counters.values()]}, poses finite "
                                 f"{bool(torch.isfinite(poses).all())}")
        with torch.no_grad(), matmul_precision(precision):
            if precision == "highest":  # decoder 2's class mask, given to both runs (see below)
                mask = model(img[:4])[..., : OBJECTS + 1]
            outputs[precision] = model(img[:4], mask).float()
        ms = cuda_ms(lambda: step(img, kp3, cam), 3, warmup=1)
        apart = ""
        if precision == "high":
            # The network's output against highest's, relative to its largest value, with decoder 2 conditioned
            # on one class mask (highest's argmax): the network is then continuous in its inputs. Left to take
            # its own argmax, TF32 moves ties between random logits, and decoder 2's output changes wholesale
            # where a pixel's class does (0.767 of its max, measured); the voted points follow, by hundreds of
            # pixels where LS voting's 2x2 systems are near singular, so they are not held. Band 1e-2, a few times
            # what TF32's 10-bit mantissa leaves after the network's convolutions.
            out_err = ((outputs["high"] - outputs["highest"]).abs().max() / outputs["highest"].abs().max()).item()
            if not out_err <= 1e-2:
                raise AssertionError(f"{label}: the network's output {out_err:.3g} of its max from highest's")
            apart = (f"; network output on one class mask {out_err:.3g} of its max from highest's (band 1e-2); "
                     f"voted points {(points['high'] - points['highest']).abs().max().item():.3g} px (max) apart")
        say("precision", t0, f"{label}: {ms:.3f} ms/step, {ms / b:.3f} ms/image{apart}")
        del step, model
        torch.cuda.empty_cache()


def phase_remat(dev, kernels):
    """19. --remat: the config_8 float32 batch-8 train step with the network forward under torch.utils.checkpoint,
    against the same step without it and against a second run without it; step ms and peak memory of both."""
    import torch

    t0 = time.time()
    opt = train_opt()
    host = train_batch(8, seed=0)
    counters = count_launches()
    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False  # deterministic cuDNN algorithms
    try:
        off = one_train_step(opt, dev, host)
        off2 = one_train_step(opt, dev, host)
        for fn in counters.values():
            fn.launches = 0
        on = one_train_step(opt, dev, host, remat=True)
        torch.cuda.synchronize()
        for name, fn in counters.items():
            kernels[name]["launches_by_path"]["train step f32 b8 remat"] = fn.launches
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    lr = off[3][1].learning_rate(0)
    spread = compare_train_steps("remat off, twice", off[:3], off2[:3], lr)
    remat = compare_train_steps("remat on against off", off[:3], on[:3], lr)
    stats_equal = all(np.array_equal(on[1][k], off[1][k]) for k in off[1] if k.endswith(("running_mean", "running_var")))
    say("remat", t0, f"f32 b8, one step from the same weights: remat on against off: losses {remat['loss_err']:.3g} "
        f"apart (rtol 1e-5), running statistics {'equal' if stats_equal else 'within rtol 1e-5'} (updated once), "
        f"gradients {remat['grad_err']:.3g} of their max apart, {remat['weights_beyond_rtol']} weights beyond rtol 1e-5 "
        f"(held through the AdamTF map); two runs without remat: losses {spread['loss_err']:.3g}, gradients "
        f"{spread['grad_err']:.3g}, {spread['weights_beyond_rtol']} weights beyond rtol 1e-5")
    del off, off2, on
    torch.cuda.empty_cache()
    for remat_on in (False, True):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, _, _, (model, optimizer, cfg, lw, step, batch, gen) = one_train_step(opt, dev, host, remat=remat_on)
        ms = cuda_ms(lambda: step(batch, gen), 5, warmup=1)
        peak = torch.cuda.max_memory_allocated()
        say("remat", t0, f"f32 b8 remat {'on' if remat_on else 'off'}: step {ms:.3f} ms ({ms / 8:.3f} ms/image), "
            f"peak memory {peak / 2**30:.2f} GiB")
        del model, optimizer, step, batch
        torch.cuda.empty_cache()


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def ddp_rank(rank, port, world, device_type, host, out_dir):
    """One rank of phase 20's multi-rank check: its rows of the global batch through the data-parallel train step."""
    from casapose_tpu_torch.parallel.mesh import init_data_parallel, shutdown

    dp = init_data_parallel(device_type, rank=rank, world_size=world, local_rank=rank,
                            init_method=f"tcp://127.0.0.1:{port}")
    try:
        rows = dp.rows(host["img"].shape[0])
        losses, state, grads, _ = one_train_step(train_opt(), dp.device, {k: v[rows] for k, v in host.items()},
                                                 data_parallel=dp)
    finally:
        shutdown()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), losses=losses, **{f"s/{k}": v for k, v in state.items()},
             **{f"g/{k}": v for k, v in grads.items()})


def multi_rank_against_one(world, device_type, host, ref, lr):
    """``world`` ranks (spawned processes, one card each) at the global batch ``host`` against ``ref``, one process on
    all of it: the comparison summary of each rank."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as out_dir:
        mp.start_processes(ddp_rank, args=(free_port(), world, device_type, host, out_dir), nprocs=world, join=True,
                           start_method="spawn")
        ranks = [np.load(os.path.join(out_dir, f"rank{r}.npz")) for r in range(world)]
        out = []
        for r in ranks:
            got = (r["losses"], {k[2:]: r[k] for k in r.files if k.startswith("s/")},
                   {k[2:]: r[k] for k in r.files if k.startswith("g/")})
            # rtol 3e-4 on the losses (tests/test_dp_invariance.py's) and gradients within 1e-3 of their max: the
            # global BatchNorm moments and DDP's mean sum in another order (2e-4 in a CPU rehearsal with gloo)
            out.append(compare_train_steps(f"{world} ranks against one", ref, got, lr, rtol=3e-4, atol=1e-6, grad_tol=1e-3))
    return out


def phase_ddp(dev, kernels, phase15_ms):
    """20. The trainer's data-parallel path: a NCCL group of world size 1 (an in-process TCP store on a free port)
    through build_train_step(..., data_parallel=...) against the same step without it; with two cards or more, two
    ranks against one at the same global batch."""
    import torch

    from casapose_tpu_torch.parallel.mesh import init_data_parallel, shutdown

    t0 = time.time()
    opt = train_opt()
    host = train_batch(4, seed=0)
    counters = count_launches()
    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    dp = init_data_parallel("cuda", rank=0, world_size=1, local_rank=0, init_method=f"tcp://127.0.0.1:{free_port()}")
    try:
        plain = one_train_step(opt, dev, host)
        for fn in counters.values():
            fn.launches = 0
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            ddp = one_train_step(opt, dp.device, host, data_parallel=dp)
            torch.cuda.synchronize()
        strides = [str(w.message) for w in caught if "Grad strides do not match" in str(w.message)]
        if strides:  # each gradient is a view of DDP's bucket (build_train_step): no copy, no layout mismatch
            raise AssertionError(f"DDP copied a gradient of another layout into its bucket: {strides[0]}")
        for name, fn in counters.items():
            kernels[name]["launches_by_path"]["train step f32 b4 ddp"] = fn.launches
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
        lr = plain[3][1].learning_rate(0)
        same = compare_train_steps("DDP world size 1 against no DDP", plain[:3], ddp[:3], lr)
        times = {}
        for label, run in (("without DDP", plain), ("DDP, world size 1", ddp)):
            _, _, _, _, step, batch, gen = run[3]
            times[label] = cuda_ms(lambda: step(batch, gen), 10, warmup=1)
        say("ddp", t0, f"f32 b4, a {torch.distributed.get_backend()} group of world size 1: one step against the same step "
            f"without DDP: losses {same['loss_err']:.3g} apart, gradients {same['grad_err']:.3g} of their max, "
            f"{same['weights_beyond_rtol']} weights beyond rtol 1e-5 (held through the AdamTF map); step "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in times.items())
            + f" (DDP costs {times['DDP, world size 1'] - times['without DDP']:.3f} ms a step; phase 15's float32 "
            f"batch-4 step {phase15_ms:.3f} ms)")
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
        shutdown()
    del plain, ddp
    torch.cuda.empty_cache()
    if torch.cuda.device_count() >= 2:
        ref = one_train_step(opt, dev, host)
        summaries = multi_rank_against_one(2, "cuda", host, ref[:3], ref[3][1].learning_rate(0))
        say("ddp", t0, "2 ranks on 2 cards against 1 at global batch 4: " + "; ".join(
            f"rank {r}: losses {s['loss_err']:.3g}, gradients {s['grad_err']:.3g}" for r, s in enumerate(summaries)))
    else:
        say("ddp", t0, "one card: the two-rank check ran only on the CPU, in the tests (tests/test_torch_ddp.py, two "
            "gloo ranks against one)")


def phase_harness_options(dev, kernels):
    """21. The harnesses' options on a written 480x640 scene: the expansion surgery in run_training from a
    port-written backup with fewer objects, --save_debug_batch, --profile_dir in run_training, and run_evaluation
    with --save_eval_batches 1 --profile_dir."""
    import contextlib
    import io

    import torch

    from casapose_tpu_torch.core.checkpoint import h5py_available, save_weights_npz
    from casapose_tpu_torch.eval import run_evaluation
    from casapose_tpu_torch.models.registry import get_model
    from casapose_tpu_torch.train import run_training

    t0 = time.time()
    counters = count_launches()
    n_images, half = 8, OBJECTS // 2

    def run(fn, opt):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            result = fn(opt, device=str(dev))
        return result, buf.getvalue()

    with tempfile.TemporaryDirectory() as tmp:
        names = write_scene(tmp, n_images=n_images)
        flags = ["--data", os.path.join(tmp, "data"), "--datatest", "", "--datameshes", os.path.join(tmp, "models"),
                 "--object", ",".join(names), "--workers", "4", "--manualseed", "1", "--pretrained", "0",
                 "--loginterval", "1"]

        # The expansion surgery: a backup of 4 objects (CLADE tables drawn, so that copied rows tell) onto 8.
        out = os.path.join(tmp, "surgery")
        os.makedirs(os.path.join(out, "frozen_model"))
        backup = get_model("casapose_c_gcu5", ver_dim=3 * K_POINTS, seg_dim=1 + half, device=dev,
                           generator=torch.Generator().manual_seed(7))
        with torch.no_grad():
            for n in range(6, 11):
                for w in ("gamma", "beta"):
                    getattr(getattr(backup, f"pv_block_{n}_clade"), w).normal_()
        save_weights_npz(os.path.join(out, "frozen_model", "backup.npz"), backup)
        mapping = [(i, i) for i in range(1, half + 1)] + [(i, i + half) for i in range(1, half + 1)]
        csv = os.path.join(tmp, "objects_to_copy.csv")
        with open(csv, "w") as f:
            f.writelines(f"{a},{b}\n" for a, b in mapping)
        _, printed = run(run_training, train_opt(*flags, "--epochs", "0", "--copy_weights_from_backup_network", "1",
                                                 "--objects_to_copy_list", csv, "--objects_in_input_network",
                                                 str(half), "--load_h5_filename", "backup", "--outf", out))
        after = torch.load(os.path.join(out, "training_checkpoints", "step_0", "state.pt"), map_location="cpu",
                           weights_only=True)["model"]
        src = backup.state_dict()
        rows_in, rows_out = [0] + [a for a, _ in mapping], [0] + [b for _, b in mapping]
        copied = [("pv_final_conv_segmentation.weight", (slice(None), 0, 0))] + [
            (f"pv_block_{n}_clade.{w}", ()) for n in range(6, 11) for w in ("gamma", "beta")]
        for name, tail in copied:
            got = after[name][(rows_out,) + tail] if tail else after[name][rows_out]
            want = src[name].cpu()[(rows_in,) + tail] if tail else src[name].cpu()[rows_in]
            if not torch.equal(got, want):
                raise AssertionError(f"surgery: {name} rows {rows_out} are not the backup's rows {rows_in}")
        say("harness options", t0, f"run_training with the expansion surgery ({half} -> {OBJECTS} objects from a "
            f"port-written backup .npz): {[ln for ln in printed.splitlines() if 'backup' in ln]}; the segmentation "
            f"conv's rows and the 10 CLADE tables' rows {rows_out} equal the backup's {rows_in}, bit for bit")

        out = os.path.join(tmp, "debug")
        state, printed = run(run_training, train_opt(*flags, "--save_debug_batch", "1", "--outf", out))
        dumped = sorted(os.listdir(os.path.join(out, "visual_batch")))
        if state is not None or len(dumped) != 2 * 4:  # config_8's batch of 4: image and mask each
            raise AssertionError(f"save_debug_batch: {state}, {dumped}")
        say("harness options", t0, f"--save_debug_batch: {dumped}, then the trainer stopped")

        for fn in counters.values():
            fn.launches = 0
        out, prof = os.path.join(tmp, "profiled"), os.path.join(tmp, "prof_train")
        state, printed = run(run_training, train_opt(*flags, "--epochs", "1", "--profile_dir", prof, "--outf", out))
        torch.cuda.synchronize()
        for name, fn in counters.items():
            kernels[name]["launches_by_path"]["train harness --profile_dir"] = fn.launches
        train_kernels = trace_kernels(os.path.join(prof, "train_trace.json"))
        if f"wrote profiler trace to {prof}" not in printed or not train_kernels:
            raise AssertionError(f"train --profile_dir: no trace or no CUDA kernel in it ({len(train_kernels)})")
        say("harness options", t0, f"run_training --profile_dir: {state.step} steps, the trace of its window (the "
            f"epoch's last step, as the JAX window clamps for a 2-step epoch) lists "
            f"{sum(train_kernels.values())} CUDA kernel launches of {len(train_kernels)} kernels, the most: "
            + ", ".join(f"{k[:50]} x{n}" for k, n in train_kernels.most_common(3)))

        for fn in counters.values():
            fn.launches = 0
        evalf, prof = os.path.join(tmp, "eval"), os.path.join(tmp, "prof_eval")
        result, printed = run(run_evaluation, eval_opt(0, "--data", os.path.join(tmp, "none"), "--datatest",
                                                       os.path.join(tmp, "data"), "--datameshes",
                                                       os.path.join(tmp, "models"), "--object", ",".join(names),
                                                       "--batchsize_test", "1", "--save_eval_batches", "1",
                                                       "--profile_dir", prof, "--evalf", evalf,
                                                       "--outf", os.path.join(tmp, "eval_out")))
        torch.cuda.synchronize()
        for name, fn in counters.items():
            kernels[name]["launches_by_path"]["eval harness --save_eval_batches --profile_dir"] = fn.launches
        eval_kernels = trace_kernels(os.path.join(prof, "eval_trace.json"))
        pnp_in_trace = sum(n for k, n in eval_kernels.items() if "solve_pnp_kernel" in k)
        visual = os.path.join(evalf, "visual_batch_eval_mask")
        per_image = [d for d in os.listdir(visual) if os.path.isdir(os.path.join(visual, d))]
        files = sorted(f for d in per_image for f in os.listdir(os.path.join(visual, d)))
        expected = {"cuboids.png", "reprojected_keypoints.png", "proxy_summary.png"} | {
            f"proxy_error_{i}.png" for i in range(K_POINTS)}
        if (result["total_images"] != n_images or not pnp_in_trace or counters["pnp"].launches == 0
                or len(per_image) != n_images or set(files) != expected
                or len([f for f in os.listdir(visual) if f.endswith("_poses.png")]) != n_images):
            raise AssertionError(f"eval --save_eval_batches --profile_dir: {result['total_images']} images, PnP kernel "
                                 f"in the trace {pnp_in_trace}, {len(per_image)} image folders holding {set(files)}")
        say("harness options", t0, f"run_evaluation --save_eval_batches 1 --profile_dir: {n_images} images, "
            f"{len(os.listdir(visual))} entries in visual_batch_eval_mask ({len(expected)} files in each image's "
            f"folder); the trace of batches 1-5 lists {sum(eval_kernels.values())} CUDA kernel launches, the PnP "
            f"kernel's {pnp_in_trace} among them; launches {dict((n, fn.launches) for n, fn in counters.items())}")
    if not h5py_available():
        say("harness options", t0, "h5py is not installed on this machine: the .h5 import, export and ImageNet "
            "backbone routes are held against the JAX package by the tests on the CPU (tests/test_torch_h5.py)")
        return
    from casapose_tpu_torch.core.checkpoint import export_keras_h5, import_keras_h5

    with tempfile.TemporaryDirectory() as tmp:
        path = export_keras_h5(os.path.join(tmp, "w.h5"), backup)
        again = get_model("casapose_c_gcu5", ver_dim=3 * K_POINTS, seg_dim=1 + half, device=dev,
                          generator=torch.Generator().manual_seed(8))
        n, skipped = import_keras_h5(path, again)
    if skipped or any(not torch.equal(v, again.state_dict()[k]) for k, v in backup.state_dict().items()):
        raise AssertionError(f".h5 round trip: {n} arrays loaded, skipped {skipped[:5]}")
    say("harness options", t0, f"h5py imports here: the backup written as .h5 and read back, {n} arrays, bit for bit")


# Phases 22-26: the serving extras (int8, the bf16c voting form, the XLA PnP path, the export, the serving CLIs).


def fidelity(out, ref):
    """tests/test_quant.py's measures of an int8 output against the float32 one: per head (segmentation, vertex)
    the median, 99th percentile and maximum of |out - ref| over the head's max |ref|; and the segmentation argmax
    agreement (reported; tests/test_torch_quant.py holds it in tests/test_quant.py's own setting)."""
    stats = {}
    for name, sl in (("seg", slice(0, SEG_DIM)), ("vertex", slice(SEG_DIM, None))):
        r, o = ref[..., sl], out[..., sl]
        rel = (o - r).abs() / r.abs().max().clamp(min=1e-6)
        q = torch_quantiles(rel, (0.5, 0.99))
        stats[name] = (q[0], q[1], rel.max().item())
    agree = (out[..., :SEG_DIM].argmax(-1) == ref[..., :SEG_DIM].argmax(-1)).float().mean().item()
    return stats, agree


def torch_quantiles(x, qs):
    """Quantiles of a tensor too large for torch.quantile, from a sorted copy on the host."""
    v = np.sort(x.reshape(-1).float().cpu().numpy())
    return [float(v[min(int(q * (v.size - 1) + 0.5), v.size - 1)]) for q in qs]


def phase_int8(dev, kernels, f32_times, bf16_times):
    """22. int8: the inference step with quantized convolutions at batch 1 and 32 beside phases 6 and 14; one
    backbone conv's and one masked partial conv's int32 sums on the card against the CPU's, bit for bit; the network
    output against float32 within tests/test_quant.py's bands; the int8 eval step at batch 32, eval_chunk 8."""
    import torch

    from casapose_tpu_torch.core.numerics import f32_precision
    from casapose_tpu_torch.entry import build_inference_step
    from casapose_tpu_torch.eval import build_test_step, loss_weights_from_opt
    from casapose_tpu_torch.models.layers import PartialConv
    from casapose_tpu_torch.models.registry import build_model_from_opt
    from casapose_tpu_torch.ops import quant
    from casapose_tpu_torch.ops.plain import plain_kernels
    from casapose_tpu_torch.ops.voting import class_masks, filtered_labels
    from casapose_tpu_torch.ops.voting_kernel import voting_accumulate, voting_accumulate_plain

    t0 = time.time()
    step, model = build_inference_step(OBJECTS, K_POINTS, H, W, device=str(dev),
                                       generator=torch.Generator().manual_seed(0), quantized="int8")
    counters = count_launches()
    rng = np.random.default_rng(22)
    cases = []
    for b in (1, 32):
        kp3 = torch.from_numpy(rng.uniform(-0.05, 0.05, (b, OBJECTS, 1, K_POINTS, 3)).astype(np.float32)).to(dev)
        cam = torch.tensor(CAMERA, device=dev).expand(b, 3, 3).contiguous()
        cases.append((b, torch.from_numpy(rng.normal(size=(b, H, W, 3)).astype(np.float32)).to(dev), kp3, cam))
    for fn in counters.values():
        fn.launches = 0
    with cc_recording() as cc_records:
        results = [step(img, kp3, cam, return_points=True) for _, img, kp3, cam in cases]
    torch.cuda.synchronize()
    for name in ("voting", "pnp", "cc"):
        kernels[name]["launches_by_path"]["inference step int8"] = counters[name].launches
    if any(counters[name].launches == 0 for name in ("voting", "pnp", "cc")):
        raise AssertionError(f"a kernel of the int8 step never launched: { {n: f.launches for n, f in counters.items()} }")
    hold_cc("inference step int8", cc_records, kernels, t0, "int8")
    for (b, img, kp3, cam), (poses, coords) in zip(cases, results):
        if tuple(poses.shape) != (b, OBJECTS, 1, 3, 4) or not torch.isfinite(poses).all():
            raise AssertionError(f"int8 step b={b}: poses not finite or of the wrong shape {tuple(poses.shape)}")
        # As phase 13 holds its variants: the step again with the PnP kernel's plain version (the same points, the
        # same available objects), and the voting kernel's sums on this int8 output against float64. The points are
        # not held against the plain voting's: on a near-singular 2x2 system a float32 rounding of the sums moves a
        # point by pixels (2 of 4608 coordinates, up to 0.97 px, at b=32 on an H100).
        with plain_kernels("pnp"):
            poses_p, coords_p = step(img, kp3, cam, return_points=True)
        if not torch.equal(coords, coords_p):
            raise AssertionError(f"int8 step b={b}: the voted points differ between two runs of the same voting")
        if not torch.equal(poses.abs().reshape(-1, 12).sum(1) > 0, poses_p.abs().reshape(-1, 12).sum(1) > 0):
            raise AssertionError(f"int8 step b={b}: the kernel and plain PnP disagree on which objects are available")
        out = quant.quantized_apply(model, img)
        lab_f = filtered_labels(*class_masks(out[..., :SEG_DIM], torch.float32, True))
        S = voting_accumulate(out, lab_f, SEG_DIM, K_POINTS)
        err, allowed = voting_vs_float64(S, voting_accumulate_plain(out.double(), lab_f, SEG_DIM, K_POINTS), SEG_DIM,
                                         K_POINTS)
        del out
        times = inference_stage_ms(step, model, img, kp3, cam, forward=lambda x: quant.quantized_apply(model, x))
        say("int8", t0, f"b={b}: poses finite; the voting kernel's sums on the int8 output against float64: worst "
            f"|dS| / allowed {(err / allowed).max().item():.3g}; with the PnP kernel's plain version the same points "
            f"and available objects")
        say("int8", t0, f"b={b} ms per step, int8 / float32 (phase 6) / bfloat16 (phase 14): " + "; ".join(
            f"{k} {v:.3f} / {f32_times[b][k]:.3f} / {bf16_times[b][k]:.3f}" for k, v in times.items())
            + f"; {times['step'] / b:.3f} / {f32_times[b]['step'] / b:.3f} / {bf16_times[b]['step'] / b:.3f} ms/image")

    # One backbone conv (stage 4's dilated 3x3, K = 4608) and one masked partial conv (decoder 2), on the inputs the
    # b=1 forward gives them: codes and int32 sums on the card equal the CPU's bit for bit.
    conv = model.backbone.stage4_unit1_conv2
    pconv = next(m for n, m in model.named_modules() if isinstance(m, PartialConv) and n.startswith("pv_block_9"))
    seen = {}
    hooks = [m.register_forward_pre_hook(lambda m, args, key=key: seen.setdefault(key, args))
             for key, m in (("conv", conv), ("partial", pconv))]
    try:
        quant.quantized_apply(model, cases[0][1])
    finally:
        for h in hooks:
            h.remove()
    x_c, (x_p, seg_p) = seen["conv"][0], seen["partial"]
    if seg_p is None:
        raise AssertionError("phase 22: the chosen partial conv ran without its class mask")
    labels = torch.argmax(seg_p, dim=1, keepdim=True)
    sums = {}
    for where in (dev, "cpu"):
        xq, _ = quant.activation_codes(x_c.to(where))
        wq, _ = quant.weight_codes(conv.weight.to(where))
        xpq, _ = quant.activation_codes(x_p.to(where))
        wpq, _ = quant.weight_codes(pconv.weight.to(where))
        sums[where] = [xq, wq, quant.conv_accumulators(xq, wq, conv.stride, conv.padding, conv.dilation), xpq, wpq,
                       quant.partial_conv_accumulators(xpq, wpq, labels.to(where))[0]]
    torch.cuda.synchronize()
    for name, a, b in zip(("conv codes", "conv weight codes", "conv sums", "partial codes", "partial weight codes",
                           "partial sums"), sums[dev], sums["cpu"]):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"int8 {name}: the card's differ from the CPU's")
    say("int8", t0, f"stage4_unit1_conv2 {tuple(x_c.shape)} (K {conv.weight[0].numel()}) and the masked partial conv "
        f"{tuple(x_p.shape)}: codes and int32 sums on the card equal the CPU's bit for bit (|sum| up to "
        f"{sums['cpu'][2].abs().max().item()} and {sums['cpu'][5].abs().max().item()})")

    # The network output against float32 within tests/test_quant.py's bands.
    img = cases[0][1]
    with torch.no_grad(), f32_precision():
        ref = model(img)
    out = quant.quantized_apply(model, img)
    stats, agree = fidelity(out, ref)
    bad = [n for n, (p50, p99, worst) in stats.items() if not (p99 < 0.05 and p50 < 0.02)]
    if bad or stats["seg"][2] >= 0.15:
        raise AssertionError(f"int8 output outside tests/test_quant.py's bands: {stats}")
    say("int8", t0, "network output b=1 against float32, |d| / head max (median, p99, max): " + "; ".join(
        f"{n} {p50:.3g}, {p99:.3g}, {worst:.3g}" for n, (p50, p99, worst) in stats.items())
        + f" (bands 0.02, 0.05, seg 0.15); segmentation argmax agreement {agree:.4f} (reported)")
    del cases, results, out, ref, sums, seen
    torch.cuda.empty_cache()

    # The int8 eval step at batch 32, eval_chunk 8, driven as phase 13 drives the others.
    opt = eval_opt(EVAL_CHUNK, "--quantized_inference", "int8")
    verts, counts = eval_meshes()
    emodel = build_model_from_opt(opt, OBJECTS, device=dev, generator=torch.Generator().manual_seed(0))
    estep = build_test_step(emodel, opt, OBJECTS, verts, counts, loss_weights_from_opt(opt))
    planted = {32: planted_eval_batch(emodel, opt, 32, seed=32, dev=dev)}
    drive_eval_path("eval step int8", estep, planted, kernels, ("voting", "pnp", "cc"), t0, phase="int8",
                    hold_planted=False)
    batch = planted[32][0]
    ms = cuda_ms(lambda: estep(batch), 2, warmup=1)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    estep(batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    say("int8", t0, f"eval step int8 b=32, eval_chunk {EVAL_CHUNK}: {ms:.3f} ms/step, {ms / 32:.3f} ms/image; peak "
        f"memory {peak / 2**30:.2f} GiB ({(peak - base) / 2**30:.2f} GiB above the {base / 2**30:.2f} GiB held before)")
    del emodel, estep, planted, batch
    torch.cuda.empty_cache()


def phase_bf16c(model, img, kernels):
    """23. The bf16c voting form on the main path's inputs (b=32, 480x640): each form's voted points against float64,
    and the form's ms beside the voting kernel's kernel_ms."""
    import torch

    from casapose_tpu_torch.core.numerics import f32_precision
    from casapose_tpu_torch.ops.voting import _solve_sums, bf16c_points, class_masks, einsum_sums, ls_voting

    t0 = time.time()
    with torch.no_grad(), f32_precision():
        out = model(img)
        seg, dirs, conf = out[..., :SEG_DIM], out[..., SEG_DIM : SEG_DIM + 2 * K_POINTS], out[..., SEG_DIM + 2 * K_POINTS :]
        _, hot = class_masks(seg, torch.float32, True)
        S64 = einsum_sums(hot.double(), dirs.double(), conf.double(), False)
        p64 = _solve_sums(S64, H)
        present = S64[..., 5].amax(-1) > 0  # [b, oc]: objects with votes
        points = {"multi (einsum form)": ls_voting(seg, dirs, conf, K_POINTS, filter_estimates=True),
                  "voting kernel": ls_voting(seg, dirs, conf, K_POINTS, filter_estimates=True, raw_output=out)}
        saved = os.environ.get("CASAPOSE_VOTING_FORM")
        os.environ["CASAPOSE_VOTING_FORM"] = "bf16c"
        try:
            points["bf16c"] = ls_voting(seg, dirs, conf, K_POINTS, filter_estimates=True, raw_output=out)
        finally:
            if saved is None:
                del os.environ["CASAPOSE_VOTING_FORM"]
            else:
                os.environ["CASAPOSE_VOTING_FORM"] = saved
        dev64 = {name: (p.double() - p64).abs()[present] for name, p in points.items()}
        err = {name: d.max().item() for name, d in dev64.items()}
        med = {name: d.median().item() for name, d in dev64.items()}
        # tests/test_voting_bf16c.py holds bf16c under 1 px on its worst-case scene. Here that holds for the median:
        # random weights give a few pixels softplus weights of ~1e4, so a class's sums rest on a handful of pixels and
        # bfloat16's 8-bit features do not average out where the 2x2 system is near-singular (the maximum, reported).
        if not all(torch.isfinite(p).all() for p in points.values()) or med["bf16c"] >= 1.0:
            raise AssertionError(f"voting forms against float64: max {err}, median {med}")
        ms_bf16c = cuda_ms(lambda: bf16c_points(hot, dirs, conf, False), 3)
        ms_multi = cuda_ms(lambda: einsum_sums(hot, dirs, conf, False), 3)
    kernels["voting"]["bf16c"] = {"ms": ms_bf16c, "max_err_px": err["bf16c"], "median_err_px": med["bf16c"],
                                  "multi_max_err_px": err["multi (einsum form)"]}
    say("bf16c", t0, f"b={img.shape[0]} {H}x{W}, {int(present.sum())} objects with votes: |points - float64| max / "
        "median " + "; ".join(f"{k} {err[k]:.4g} / {med[k]:.3g} px" for k in err)
        + f"; bf16c sums + solve {ms_bf16c:.3f} ms, multi's six float32 sums {ms_multi:.3f} ms, the voting kernel's "
        f"kernel_ms {kernels['voting']['kernel_ms']:.4f} ms")
    del out, seg, dirs, conf, hot, S64, p64, points
    torch.cuda.empty_cache()


def phase_xla_pnp(dev, kernels):
    """24. The XLA PnP path (CASAPOSE_PNP_REFINE=xla) against the PnP kernel on planted problems at B = 8, 64, 256:
    R atol 1e-4, t 2e-4, and its call_ms beside the kernel's."""
    import torch

    from casapose_tpu_torch.ops.pnp_kernel import solve_pnp_kernel
    from casapose_tpu_torch.pose.epnp import solve_pnp
    from casapose_tpu_torch.pose.geometry import rodrigues

    t0 = time.time()
    saved = os.environ.get("CASAPOSE_PNP_REFINE")
    kernels["pnp"]["xla_call_ms_by_B"] = {}
    try:
        for B in (8, 64, 256):
            p2, p3, Kn, R_gt, t_gt = (torch.from_numpy(a).to(dev) for a in pnp_problems(B, 0, seed=B + 24))
            Rk, tk, _ = solve_pnp_kernel(p2, p3, Kn)
            os.environ["CASAPOSE_PNP_REFINE"] = "xla"
            p6d = solve_pnp(p2, p3, Kn)
            xla_ms = cuda_ms(lambda: solve_pnp(p2, p3, Kn), 3)
            os.environ["CASAPOSE_PNP_REFINE"] = "pallas"
            kernel_call = cuda_ms(lambda: solve_pnp_kernel(p2, p3, Kn), 20)
            Rx, tx = rodrigues(p6d[:, :3]), p6d[:, 3:]
            dR, dt = (Rx - Rk).abs().max().item(), (tx - tk).abs().max().item()
            gR, gt = (Rx - R_gt).abs().max().item(), (tx - t_gt).abs().max().item()
            if not (dR <= 1e-4 and dt <= 2e-4):
                raise AssertionError(f"XLA PnP path against the kernel at B={B}: |dR| {dR}, |dt| {dt}")
            kernels["pnp"]["xla_call_ms_by_B"][B] = xla_ms
            say("xla pnp", t0, f"B={B} planted: XLA path vs kernel max|dR| {dR:.3g} max|dt| {dt:.3g} (atol R 1e-4, t "
                f"2e-4), vs planted max|dR| {gR:.3g} max|dt| {gt:.3g}; call_ms XLA path {xla_ms:.3f}, kernel "
                f"{kernel_call:.4f}")
    finally:
        if saved is None:
            os.environ.pop("CASAPOSE_PNP_REFINE", None)
        else:
            os.environ["CASAPOSE_PNP_REFINE"] = saved


def phase_export(dev, model, kernels):
    """25. The float32 serving program at 480x640, batch 1, on the card: export, save, load, call; its poses against
    the live function's (1e-6), its kernels' launches inside the loaded program, its size and times."""
    import torch

    from casapose_tpu_torch.core.export import build_serving_fn, export_inference, load_exported
    from casapose_tpu_torch.core.numerics import f32_precision

    t0 = time.time()
    rng = np.random.default_rng(25)
    img = torch.from_numpy(rng.normal(size=(1, H, W, 3)).astype(np.float32)).to(dev)
    kp3 = torch.from_numpy(rng.uniform(-0.05, 0.05, (1, OBJECTS, 1, K_POINTS, 3)).astype(np.float32)).to(dev)
    cam = torch.tensor(CAMERA, device=dev)[None].contiguous()
    serve = build_serving_fn(model, OBJECTS, K_POINTS)

    def live():
        with torch.no_grad(), f32_precision():
            return serve(img, kp3, cam)

    t1 = time.time()
    blob = export_inference(model, 1, H, W, OBJECTS, K_POINTS, device=str(dev))
    export_s = time.time() - t1
    t1 = time.time()
    program = load_exported(blob)
    load_s = time.time() - t1
    counters = count_launches()
    for fn in counters.values():
        fn.launches = 0
    got = program(img, kp3, cam)
    torch.cuda.synchronize()
    launches = {n: counters[n].launches for n in ("voting", "pnp")}
    for name, n in launches.items():
        kernels[name]["launches_by_path"]["exported program"] = n
    if not all(launches.values()):
        raise AssertionError(f"the exported program did not launch every kernel: {launches}")
    want = live()
    if tuple(got.shape) != (1, OBJECTS, 1, 3, 4) or not torch.isfinite(got).all():
        raise AssertionError(f"exported program: poses {tuple(got.shape)} not finite or of the wrong shape")
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)  # tests/test_export.py's band
    # Program, live, live, program: of two timings of a batch-1 step in a row, the first has read slower.
    ms = {"program": [], "live": []}
    for name in ("program", "live", "live", "program"):
        ms[name].append(cuda_ms((lambda: program(img, kp3, cam)) if name == "program" else live, 10, warmup=2))
    say("export", t0, f"b=1 {H}x{W}: exported in {export_s:.2f} s, {len(blob) / 1e6:.3f} MB, loaded in {load_s:.2f} s; "
        f"poses equal the live function's {'bit for bit' if torch.equal(got, want) else 'within 1e-6'} (max|d| "
        f"{(got - want).abs().max().item():.3g}); launches inside the program {launches}; ms per call, in the order "
        f"program, live, live, program: {ms['program'][0]:.3f}, {ms['live'][0]:.3f}, {ms['live'][1]:.3f}, "
        f"{ms['program'][1]:.3f}")


def phase_serving_clis(dev):
    """26. python -m casapose_tpu_torch.test_minimal and export_model on a written scene (int8 through test_minimal
    is held on the CPU, tests/test_torch_serving_cli.py; the int8 step itself in phase 22)."""
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        names = write_scene(tmp, n_images=12)
        flags = ["-c", os.path.join(ROOT, "configs", "config_8.ini"), "--objects_to_copy_list", "",
                 "--datatest", os.path.join(tmp, "data"), "--data", os.path.join(tmp, "none"),
                 "--datameshes", os.path.join(tmp, "models"), "--object", ",".join(names),
                 "--outf", os.path.join(tmp, "out")]
        runs = [("test_minimal", ["--evalf", os.path.join(tmp, "eval")]),
                ("export_model", ["--export_path", os.path.join(tmp, "serving", "casapose.pt2"),
                                  "--batchsize_test", "1", "--imagesize_test", str(H), str(W)])]
        for module, extra in runs:
            proc = subprocess.run([sys.executable, "-m", f"casapose_tpu_torch.{module}", *flags, *extra, "--device",
                                   str(dev)], cwd=ROOT,
                                  env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                raise AssertionError(f"{module} failed (rc {proc.returncode}):\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
            lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(("mean time", "wrote"))]
            if module == "test_minimal":
                with open(os.path.join(extra[1], "speed_eval.csv")) as f:
                    rows = f.read().strip().splitlines()
                if rows[0] != "batchid,time" or len(rows) != 14 or not rows[-1].startswith("mean,"):
                    raise AssertionError(f"test_minimal wrote an unexpected speed_eval.csv: {rows}")
            elif not os.path.getsize(extra[1]):
                raise AssertionError("export_model wrote an empty program")
            say("clis", t0, f"{module} {' '.join(extra[2:]) or ''}: " + " | ".join(lines))


# The CC labelling kernel (csrc/cc.cu): its launches recorded on each path and held against the plain loop.
def serpentine(h, w, vertical=False):
    """One snake of 1-pixel corridors joined at alternating ends, [1, h, w] bool: a flood sweep carries a label one
    corridor further, so it needs about as many sweeps as it has corridors (w / 2 vertical ones, h / 2 across)."""
    if vertical:
        return np.ascontiguousarray(serpentine(w, h)[0].T[None])
    fg = np.zeros((1, h, w), bool)
    for r in range(0, h, 2):
        fg[0, r, :] = True
        if r + 1 < h:
            fg[0, r + 1, (w - 1) if (r // 2) % 2 == 0 else 0] = True
    return fg


class cc_recording:
    """Inside: every call of the CC kernel's wrapper, as the ``casapose::connected_components`` operator makes it, is
    recorded as (fg, labels, sweeps per mask); the wrapper itself still counts its launches."""

    def __enter__(self):
        import casapose_tpu_torch.ops.connected_components as cc

        self.cc, self.real, self.records = cc, cc.connected_components_kernel, []

        def record(fg, max_sweeps=cc.MAX_SWEEPS, return_sweeps=False):
            labels, sweeps = self.real(fg, max_sweeps, return_sweeps=True)
            self.records.append((fg.clone(), labels.clone(), sweeps.clone(), max_sweeps))
            return (labels, sweeps) if return_sweeps else labels

        cc.connected_components_kernel = record
        return self.records

    def __exit__(self, *exc):
        self.cc.connected_components_kernel = self.real


def hold_cc(label, records, kernels, t0, phase):
    """Each recorded CC launch of a path against the plain loop on its masks: labels exactly equal, and the kernel's
    largest per-mask sweep count equal to the loop's count. Records the sweeps each call needed, and how many masks
    reached the cap with labels that are not final, under ``label``."""
    import torch

    from casapose_tpu_torch.ops.connected_components import connected_components_plain

    if not records:
        raise AssertionError(f"{label}: no CC launch was recorded")
    sweeps, at_cap, not_final, shapes = [], 0, 0, set()
    for fg, labels, per_mask, cap in records:
        plain, n = connected_components_plain(fg, cap, return_sweeps=True)
        if not torch.equal(labels, plain):
            raise AssertionError(f"{label}: the CC kernel's labels differ from the plain loop's on {tuple(fg.shape)} "
                                 f"in {int((labels != plain).sum())} pixels")
        if int(per_mask.max()) != n:
            raise AssertionError(f"{label}: the CC kernel ran {int(per_mask.max())} sweeps, the plain loop {n}")
        sweeps.append(n)
        shapes.add(tuple(fg.shape))
        if n == cap:
            at_cap += int((per_mask == cap).sum())
            not_final += int((connected_components_plain(fg, 4096) != plain).reshape(fg.shape[0], -1).any(1).sum())
    kernels["cc"]["sweeps_by_path"][label] = {"calls": len(records), "shapes": sorted(shapes), "sweeps": sweeps,
                                              "masks_at_cap": at_cap, "masks_not_final_at_cap": not_final}
    say(phase, t0, f"{label}: {len(records)} CC launches on masks {sorted(shapes)}, labels equal to the plain loop's "
        f"exactly; sweeps per call {sweeps} (cap {records[0][3]}); masks at the cap {at_cap}, of them not final "
        f"{not_final}")


def phase_cc(dev, kernels, main_fg, full_fg):
    """27. The CC kernel against its plain loop at the default resolution (the main path's own masks, phase 5's
    b=32 noise batch: 256 masks of 120x160), at full resolution (the same batch's 480x640 class masks, the
    --cc_filter_downsample 1 path) and on serpentines that reach the 64-sweep cap; labels exactly equal, sweeps
    counted; kernel_ms, call_ms and the plain loop's ms at both resolutions, with a byte bound."""
    import torch

    from casapose_tpu_torch.ops.connected_components import (
        MAX_SWEEPS,
        connected_components_kernel,
        connected_components_plain,
    )

    t0 = time.time()
    k = kernels["cc"]
    cases = [("default resolution, the main path's masks", main_fg), ("full resolution", full_fg),
             ("serpentine 120x160 (80 vertical corridors)", torch.from_numpy(serpentine(120, 160, True)).to(dev)),
             ("serpentine 480x640 (240 corridors across)", torch.from_numpy(serpentine(480, 640)).to(dev))]
    for name, fg in cases:
        labels, per_mask = connected_components_kernel(fg, return_sweeps=True)
        labels2 = connected_components_kernel(fg)
        plain, n = connected_components_plain(fg, return_sweeps=True)
        torch.cuda.synchronize()
        if not (torch.equal(labels, plain) and torch.equal(labels, labels2)):
            raise AssertionError(f"cc {name}: the kernel's labels differ from the plain loop's "
                                 f"({int((labels != plain).sum())} pixels) or between two runs")
        if int(per_mask.max()) != n:
            raise AssertionError(f"cc {name}: the kernel ran {int(per_mask.max())} sweeps, the plain loop {n}")
        if name.startswith("serpentine") and n != MAX_SWEEPS:
            raise AssertionError(f"cc {name}: {n} sweeps, expected the cap {MAX_SWEEPS}")
        m, h, w = fg.shape
        small = h * w <= 120 * 160  # the shared-memory path; larger masks sweep in device memory, ~100x slower
        own = kernel_ms("cc", lambda: connected_components_kernel(fg), iters=20 if small else 4, reps=5 if small else 1)
        call = cuda_ms(lambda: connected_components_kernel(fg), 20 if small else 2)
        plain_ms = cuda_ms(lambda: connected_components_plain(fg), 2, warmup=0)
        # Bytes: each mask read once (1 byte a pixel), its labels written once (4 bytes), a sweep count a mask.
        # Operations: what these masks need, each mask's own sweeps over its pixels, ~8 integer operations a pixel
        # and sweep (both passes: read, test, max, compare, store), at the float32 rate outside the tensor cores
        # (the table gives no int32 rate).
        c_bytes = m * h * w * 5 + m * 4
        c_ops = int(per_mask.sum()) * h * w * 8
        bound = max(c_bytes / PEAK_BYTES_PER_S, c_ops / PEAK_F32_FLOP_PER_S) * 1e3
        by = "bytes" if c_bytes / PEAK_BYTES_PER_S >= c_ops / PEAK_F32_FLOP_PER_S else "operations"
        k.setdefault("by_case", {})[name] = {"shape": [m, h, w], "sweeps": n, "kernel_ms": own, "call_ms": call,
                                             "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by}
        if name.startswith("default"):
            k.update(kernel_ms=own, ms=own, call_ms=call, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                     library_ms=None)
        say("cc", t0, f"{name} {[m, h, w]}: labels equal to the plain loop's exactly, the same on a second run; "
            f"{n} sweeps (per mask up to {int(per_mask.max())}, median {int(per_mask.float().median())}); kernel_ms "
            f"{own:.4f} ({KERNEL_MS_METHOD['cc']}), call_ms {call:.4f}, plain loop {plain_ms:.3f} ms, bound "
            f"{bound:.6f} ms ({by}), {bound / own:.2%} of it")


def phase_sync(dev):
    """28. The inference step (float32 and bfloat16) and the LS evaluation step (float32 and bfloat16, eval_chunk 8)
    at batch 1 and 32 under torch.cuda.set_sync_debug_mode("error"): no call reads a value back to the host. Each
    step runs once before (its one-time set-up: cuDNN plans, kernel libraries loaded, the voting grid sized)."""
    import torch

    from casapose_tpu_torch.entry import build_inference_step
    from casapose_tpu_torch.eval import build_test_step, loss_weights_from_opt
    from casapose_tpu_torch.models.registry import build_model_from_opt

    t0 = time.time()
    rng = np.random.default_rng(28)
    checked = []

    def strict(label, fn):
        fn()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        checked.append(label)

    for dtype in (torch.float32, torch.bfloat16):
        step, model = build_inference_step(OBJECTS, K_POINTS, H, W, device="cuda", dtype=dtype,
                                           generator=torch.Generator().manual_seed(0))
        for b in (1, 32):
            img = torch.from_numpy(rng.normal(size=(b, H, W, 3)).astype(np.float32)).to(dev)
            kp3 = torch.from_numpy(rng.uniform(-0.05, 0.05, (b, OBJECTS, 1, K_POINTS, 3)).astype(np.float32)).to(dev)
            cam = torch.tensor(CAMERA, device=dev).expand(b, 3, 3).contiguous()
            strict(f"inference {str(dtype)[6:]} b={b}", lambda: step(img, kp3, cam))
        del step, model
    verts, counts = eval_meshes()
    for flags in ((), ("--compute_dtype", "bfloat16")):
        opt = eval_opt(EVAL_CHUNK, *flags)
        model = build_model_from_opt(opt, OBJECTS, device=dev, generator=torch.Generator().manual_seed(0))
        step = build_test_step(model, opt, OBJECTS, verts, counts, loss_weights_from_opt(opt))
        for b in (1, 32):
            batch, _ = planted_eval_batch(model, opt, b, seed=b, dev=dev)
            strict(f"eval {opt.compute_dtype} b={b}", lambda: step(batch))
        del model, step
    torch.cuda.empty_cache()
    say("sync", t0, f"no synchronizing CUDA operation under set_sync_debug_mode('error'): {', '.join(checked)}")


def harness_files(evalf):
    """Every file the eval harness wrote under ``evalf``, time columns left out: {relative path: text or bytes}."""
    out = {}
    for d, _, fs in os.walk(evalf):
        for f in fs:
            path = os.path.join(d, f)
            rel = os.path.relpath(path, evalf)
            with open(path, "rb") as fh:
                data = fh.read()
            if rel in ("loss_test_eval.csv", "test_summary_eval.csv", os.path.join("poses_out", "bop_evaluation.csv")):
                lines = data.decode().strip().splitlines()
                col = 6 if rel == "loss_test_eval.csv" else lines[0].split(",").index("time")
                data = [lines[0]] + [",".join(x for i, x in enumerate(r.split(",")) if i != col) for r in lines[1:]]
            out[rel] = data
    return out


def phase_pipeline(dev, n_images=48, b=4, extra=()):
    """29. The eval harness (run_evaluation, in this process) serial (CASAPOSE_EVAL_PIPELINE=0) against pipelined (the
    default) on a written 480x640, 8-object scene of 48 images at --batchsize_test 4 (12 batches), in the order serial,
    pipelined, pipelined, serial: the files each run writes equal apart from their time columns; steady img/s of each
    run (batch 0's device work excluded) and its host phases."""
    from casapose_tpu_torch.eval import run_evaluation
    from casapose_tpu_torch.utils.config import parse_config

    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        names = write_scene(tmp, n_images=n_images, seed=29)
        runs = []
        try:
            for i, mode in enumerate(("0", "1", "1", "0")):
                os.environ["CASAPOSE_EVAL_PIPELINE"] = mode
                evalf = os.path.join(tmp, f"eval{i}")
                opt = parse_config(["-c", os.path.join(ROOT, "configs", "config_8.ini"), "--objects_to_copy_list", "",
                                    "--datatest", os.path.join(tmp, "data"), "--data", os.path.join(tmp, "none"),
                                    "--datameshes", os.path.join(tmp, "models"), "--object", ",".join(names),
                                    "--batchsize_test", str(b), "--write_poses", "1", "--loginterval", "100",
                                    "--outf", os.path.join(tmp, f"out{i}"), "--evalf", evalf, *extra])
                res = run_evaluation(opt, device=str(dev))
                if res["total_images"] != n_images:
                    raise AssertionError(f"harness run {i}: {res['total_images']} of {n_images} images evaluated")
                runs.append((mode, res, harness_files(evalf)))
        finally:
            os.environ.pop("CASAPOSE_EVAL_PIPELINE", None)
    for mode, res, files in runs[1:]:
        if files != runs[0][2]:
            bad = sorted(k for k in set(files) | set(runs[0][2]) if files.get(k) != runs[0][2].get(k))
            raise AssertionError(f"the harness with CASAPOSE_EVAL_PIPELINE={mode} wrote other files than the serial "
                                 f"run: {bad[:5]}")
    for i, (mode, res, files) in enumerate(runs):
        phases = ", ".join(f"{k} {v:.3f}" for k, v in res["phase_seconds"].items())
        say("pipeline", t0, f"run {i + 1} {'pipelined' if mode == '1' else 'serial'}: steady "
            f"{res['steady_img_per_sec']:.2f} img/s, wall {res['wall_seconds']:.3f} s for {res['total_images']} images "
            f"(time column mean {res['mean_time']:.5f} s/batch); host seconds {phases}")
    say("pipeline", t0, f"{len(runs[0][2])} files from each run, equal apart from their time columns (CSVs, "
        "summary, pose files)")


def write_bop_scene(root, n_images=4, seed=30):
    """A synthetic BOP dataset at 640x480: two cube objects (quads) with keypoint PLYs and models_info.json, one
    scene of ``n_images`` images with scene_camera / scene_gt / scene_gt_info and mask_visib images."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    models = os.path.join(root, "models")
    os.makedirs(models)
    s = 40.0
    corners = [[x, y, z] for x in (-s, s) for y in (-s, s) for z in (-s, s)]
    quads = [[0, 1, 3, 2], [4, 5, 7, 6], [0, 1, 5, 4], [2, 3, 7, 6], [0, 2, 6, 4], [1, 3, 7, 5]]
    vertex = "property float x\nproperty float y\nproperty float z\n"
    for oid in (1, 2):
        with open(os.path.join(models, f"obj_{oid:06d}.ply"), "w") as f:
            f.write(f"ply\nformat ascii 1.0\nelement vertex 8\n{vertex}"
                    "element face 6\nproperty list uchar int vertex_indices\nend_header\n")
            f.writelines(f"{v[0]} {v[1]} {v[2]}\n" for v in corners)
            f.writelines("4 " + " ".join(map(str, q)) + "\n" for q in quads)
        with open(os.path.join(models, f"obj_{oid:06d}_keypoints.ply"), "w") as f:
            f.write(f"ply\nformat ascii 1.0\nelement vertex {K_POINTS}\n{vertex}end_header\n")
            f.writelines(f"{v[0]} {v[1]} {v[2]}\n" for v in rng.uniform(-s, s, (K_POINTS, 3)))
    with open(os.path.join(models, "models_info.json"), "w") as f:
        json.dump({str(oid): {"diameter": 2 * s * 3 ** 0.5} for oid in (1, 2)}, f)
    scene = os.path.join(root, "train_pbr", "000000")
    for sub in ("rgb", "mask_visib"):
        os.makedirs(os.path.join(scene, sub))
    K = np.array(CAMERA)
    cams, gts, infos = {}, {}, {}
    for i in range(n_images):
        cams[str(i)] = {"cam_K": K.reshape(-1).tolist(), "depth_scale": 0.1}
        objs, inf = [], []
        for j, oid in enumerate((1, 2)):
            R = random_rotations(rng, 1)[0]
            t = [120.0 * (j - 0.5), 10.0 * i, 700.0]
            objs.append({"obj_id": oid, "cam_R_m2c": R.reshape(-1).tolist(), "cam_t_m2c": t})
            u, v = (K @ np.array(t) / t[2])[:2]
            box = [int(u) - 50, int(v) - 50, 100, 100]
            inf.append({"bbox_obj": box, "bbox_visib": box, "px_count_all": 10000, "px_count_valid": 10000,
                        "px_count_visib": 10000, "visib_fract": 1.0})
            mask = np.zeros((H, W), np.uint8)
            mask[box[1] : box[1] + 100, box[0] : box[0] + 100] = 255
            Image.fromarray(mask).save(os.path.join(scene, "mask_visib", f"{i:06d}_{j:06d}.png"))
        gts[str(i)], infos[str(i)] = objs, inf
        Image.fromarray(rng.integers(0, 255, (H, W, 3)).astype(np.uint8)).save(os.path.join(scene, "rgb", f"{i:06d}.png"))
    for name, data in (("scene_camera.json", cams), ("scene_gt.json", gts), ("scene_gt_info.json", infos)):
        with open(os.path.join(scene, name), "w") as f:
            json.dump(data, f)
    return ["obj_000001", "obj_000002"]


def phase_converter(dev):
    """30. python -m casapose_tpu_torch.dataset_converter on a synthetic BOP scene written here (reuse masks, and
    render masks from the cube meshes), then one batch of the port's eval harness on the converted scene."""
    from PIL import Image

    from casapose_tpu_torch.eval import run_evaluation
    from casapose_tpu_torch.utils.config import parse_config

    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        names = write_bop_scene(os.path.join(tmp, "bop"))
        for mode in ("render", "reuse"):
            out = os.path.join(tmp, mode)
            proc = subprocess.run([sys.executable, "-m", "casapose_tpu_torch.dataset_converter", os.path.join(tmp, "bop"),
                                   out, "--mask", mode, "--copy_meshes", "1"], cwd=ROOT,
                                  env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                raise AssertionError(f"the converter failed (rc {proc.returncode}):\n{proc.stdout[-3000:]}\n"
                                     f"{proc.stderr[-3000:]}")
            rgb = os.path.join(out, "train_pbr", "000000", "rgb")
            ids = [set(np.unique(np.asarray(Image.open(os.path.join(rgb, f"{i:06d}.seg.png"))))) for i in range(4)]
            if any(s != {0, 1, 2} for s in ids):
                raise AssertionError(f"converter {mode}: the masks hold the ids {ids}, expected 0, 1 and 2 each")
            say("converter", t0, f"{mode} masks: converted 4 images of {W}x{H} with 2 objects, masks hold ids 0, 1, 2")
        opt = parse_config(["--datatest", os.path.join(tmp, "reuse", "train_pbr"), "--data", os.path.join(tmp, "none"),
                            "--datameshes", os.path.join(tmp, "reuse", "models"), "--object", ",".join(names),
                            "--modelname", "casapose_c_gcu5", "--estimate_confidence", "1", "--estimate_coords", "1",
                            "--no_points", str(K_POINTS), "--imagesize_test", str(H), str(W), "--batchsize_test", "4",
                            "--min_object_size_test", "1", "--outf", os.path.join(tmp, "out"),
                            "--evalf", os.path.join(tmp, "eval")])
        res = run_evaluation(opt, device=str(dev))
        with open(os.path.join(tmp, "eval", "test_summary_eval.csv")) as f:
            summary = f.read().strip().splitlines()
        values = [float(x) for x in summary[1].split(",")]
        if res["total_images"] != 4 or not np.isfinite(values).all() or not np.isfinite(res["loss"]).all():
            raise AssertionError(f"the eval harness on the converted scene: {res['total_images']} images, {summary}")
        say("converter", t0, f"the eval harness on the converted scene: 1 batch of 4 images, losses "
            f"{np.array2string(res['loss'], precision=5)}, summary row {summary[1]}")


def trace_kernels(path):
    """Launch counts by kernel name of the CUDA kernels in a torch.profiler Chrome trace."""
    import collections

    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return collections.Counter(e["name"] for e in events if e.get("cat") == "kernel")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from casapose_tpu_torch.core.numerics import f32_precision
    from casapose_tpu_torch.entry import build_inference_step
    from casapose_tpu_torch.ops import _build
    from casapose_tpu_torch.ops.connected_components import connected_components_kernel
    from casapose_tpu_torch.ops.plain import plain_kernels
    from casapose_tpu_torch.ops.pnp_kernel import solve_pnp_kernel, solve_pnp_plain
    from casapose_tpu_torch.ops.voting import class_masks, einsum_sums, filtered_labels
    from casapose_tpu_torch.ops.voting_kernel import voting_accumulate, voting_accumulate_plain
    from casapose_tpu_torch.pose.epnp import pose_matrix_from_p6d, solve_pnp, substitute_degenerate

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
    kernels["cc"] = {"max_abs_err": 0, "launches_by_path": {}, "sweeps_by_path": {}}

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
    launch_counters = {"voting": voting_accumulate, "pnp": solve_pnp_kernel, "cc": connected_components_kernel}
    for fn in launch_counters.values():
        fn.launches = 0
    with cc_recording() as cc_records:
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
    hold_cc("inference step", cc_records, kernels, t0, "step")
    main_fg = cc_records[-1][0]  # noise b=32: the main path's own 256 masks of 120x160
    del results, cc_records

    # 6. timings: the step, its stages (as the step runs them: no grad, TF32 off), then each kernel
    t0 = time.time()
    f32_times = {}
    for label, img, kp3, cam in cases:
        if label.startswith("noise"):
            b = img.shape[0]
            f32_times[b] = stages = inference_stage_ms(step, model, img, kp3, cam)
            say("time", t0, f"step {label}: {stages['step']:.3f} ms/step, {stages['step'] / b:.3f} ms/image")
            say("time", t0, f"stages {label}: " + "; ".join(f"{k} {v:.3f} ms" for k, v in stages.items() if k != "step"))
    _, img, kp3, cam = cases[-1]  # noise b=32: the main path's own kernel inputs
    with torch.no_grad(), f32_precision():
        out = model(img)
    seg, dirs, conf = out[..., :SEG_DIM], out[..., SEG_DIM : SEG_DIM + 2 * K_POINTS], out[..., SEG_DIM + 2 * K_POINTS :]
    labels, hot = class_masks(seg, torch.float32, True)
    lab_f = filtered_labels(labels, hot)
    # The same batch's class masks at full resolution, for the CC kernel at --cc_filter_downsample 1 (phase 27).
    full_fg = (labels[..., None] == torch.arange(1, SEG_DIM, device=dev)).permute(0, 3, 1, 2).reshape(-1, H, W)
    full_fg = full_fg.contiguous()
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
    phase_models(dev)  # 12
    phase_eval_paths(dev, kernels)  # 13
    bf16_times = phase_bf16_inference(dev, kernels, f32_times)  # 14
    torch.cuda.empty_cache()
    train_ms = phase_train_steps(dev, kernels)  # 15
    phase_bpnp(dev, kernels)  # 16
    phase_train_harness(dev, kernels)  # 17
    torch.cuda.empty_cache()
    phase_precision(dev, kernels)  # 18
    phase_remat(dev, kernels)  # 19
    phase_ddp(dev, kernels, train_ms["train step f32 b4"])  # 20
    phase_harness_options(dev, kernels)  # 21
    torch.cuda.empty_cache()
    phase_int8(dev, kernels, f32_times, bf16_times)  # 22
    phase_bf16c(model, img, kernels)  # 23: phase 6's b=32 noise image through phase 5's model
    phase_xla_pnp(dev, kernels)  # 24
    phase_export(dev, model, kernels)  # 25
    phase_serving_clis(dev)  # 26
    del model, img
    torch.cuda.empty_cache()
    phase_cc(dev, kernels, main_fg, full_fg)  # 27
    del main_fg, full_fg
    phase_sync(dev)  # 28
    phase_pipeline(dev)  # 29
    phase_converter(dev)  # 30

    meta = {
        "voting": ("casapose_tpu_torch/csrc/voting.cu", "casapose_tpu/ops/voting_kernel.py:103"),
        "pnp": ("casapose_tpu_torch/csrc/pnp.cu", "casapose_tpu/ops/pnp_kernel.py:489"),
        "lm_refine": ("casapose_tpu_torch/csrc/pnp.cu", "casapose_tpu/ops/pnp_kernel.py:167"),
        # Not a TPU kernel: the JAX package labels in XLA, a lax.while_loop of flood sweeps (no pallas_call).
        "cc": ("casapose_tpu_torch/csrc/cc.cu", "casapose_tpu/ops/connected_components.py:50"),
    }
    line = []
    for name, (source, replaces) in meta.items():
        k = kernels[name]
        line.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": sum(k["launches_by_path"].values()), "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                     "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
                     "library_ms": k["library_ms"], "kernel_ms": k["kernel_ms"], "call_ms": k["call_ms"],
                     "kernel_ms_method": KERNEL_MS_METHOD[name], "launches_by_path": k["launches_by_path"],
                     **{key: k[key] for key in ("kernel_ms_by_B", "kernel_ms_random_labels", "xla_call_ms_by_B", "bf16c",
                                                "sweeps_by_path", "by_case") if key in k},
                     **({"pallas_call": False} if name == "cc" else {})})
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
