#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (casapose_tpu_torch) on one CUDA card.

    python3 chip_smoke.py            # from the repository root; needs one card

Phases, one line each with its seconds:
  1. device: nvidia-smi name and power limit, torch and CUDA versions;
  2. build: every kernel in casapose_tpu_torch/csrc, one nvcc per source,
     all started together, with ptxas's register / spill report;
  3. pnp: the PnP kernel against its plain version at B=256, N=9 on planted
     poses and random rows, and all-zero rows through solve_pnp;
  4. voting: the voting kernel against its plain version run in float64 at
     b=1 and b=32, 480x640, C=36, and the same bits on a second run;
  5. step: the flagship inference step (casapose_c_gcu5 -> CC-filtered LS
     voting -> EPnP+LM) at 480x640, 8 objects, 9 keypoints, float32 with
     TF32 off, random weights from a seed, at batch 1 and 32 on a zero and a
     noise image; every kernel must launch, every pose must be finite, and
     the voted points must agree with the same step run through the
     kernels' plain versions on the card; how the two steps' poses
     reproject is reported (random weights make the PnP problems
     ill-posed; phase 3 holds the poses elementwise on planted problems);
  6. timings with CUDA events: ms/image of the step and of its stages, each
     kernel, its plain version and, where one exists, a PyTorch yardstick
     (library_ms).
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


def random_rotations(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack(
        [
            np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
            np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
            np.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
        ],
        axis=1,
    )


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


def voting_inputs(b, seed):
    """Raw output [b, H, W, C] (normal noise, one planted blob whose directions point at a keypoint) and
    random labels [b, H, W] in 0..8 with the blob labelled 1."""
    rng = np.random.default_rng(seed)
    raw = rng.normal(size=(b, H, W, CHANNELS)).astype(np.float32)
    labels = rng.integers(0, SEG_DIM, (b, H, W)).astype(np.int32)
    y0, x0 = 200, 300
    yy, xx = np.mgrid[y0 : y0 + 64, x0 : x0 + 96]
    for j in range(K_POINTS):
        ky, kx = rng.uniform(0, H), rng.uniform(0, W)
        raw[:, y0 : y0 + 64, x0 : x0 + 96, SEG_DIM + 2 * j] = ky - yy
        raw[:, y0 : y0 + 64, x0 : x0 + 96, SEG_DIM + 2 * j + 1] = kx - xx
    labels[:, y0 : y0 + 64, x0 : x0 + 96] = 1
    return raw, labels


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


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from casapose_tpu_torch.core.numerics import f32_precision
    from casapose_tpu_torch.entry import build_inference_step
    from casapose_tpu_torch.ops import _build
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
    Rp, tp, ep = solve_pnp_plain(p2c, p3c, Kc)
    torch.cuda.synchronize()
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
        f"8 all-zero rows -> placeholder pose")

    # 4. voting kernel against its plain version, b = 1 and 32
    t0 = time.time()
    for b in (1, 32):
        raw_np, lab_np = voting_inputs(b, seed=b)
        raw, lab = torch.from_numpy(raw_np).to(dev), torch.from_numpy(lab_np).to(dev)
        S1 = voting_accumulate(raw, lab, SEG_DIM, K_POINTS)
        S2 = voting_accumulate(raw, lab, SEG_DIM, K_POINTS)
        Sp = voting_accumulate_plain(raw, lab, SEG_DIM, K_POINTS)
        S64 = voting_accumulate_plain(raw.double(), lab, SEG_DIM, K_POINTS)
        torch.cuda.synchronize()
        # Held against the plain version in float64, as tests/test_voting_kernel.py:51 holds the Pallas
        # kernel against a float64 oracle: atol 2e-4 plus rtol 2e-5 of the sum of |terms|. A class here
        # sums ~34,000 terms whose signed features cancel, so float32 rounding in ANY order is ~1e-7 of
        # that absolute sum, not of |S|. |a|, |b|, |d| <= w and |qy|, |qx| <= w (1 + W/H) bound it by the
        # weight mass S[..., 5].
        scale = torch.tensor([1.0, 1.0, 1.0, 1 + W / H, 1 + W / H, 1.0], device=dev, dtype=torch.float64)
        allowed = 2e-4 + 2e-5 * S64[..., 5:6] * scale
        err = (S1.double() - S64).abs()
        plain_err = (Sp.double() - S64).abs()
        if not (err <= allowed).all():
            raise AssertionError(f"voting kernel disagrees with float64: worst |dS| / allowed {(err / allowed).max().item()}")
        if not torch.equal(S1, S2):
            raise AssertionError("voting kernel: two runs differ in their bits")
        kernels["voting"] = {"max_abs_err": (S1 - Sp).abs().max().item()}
        say("voting", t0, f"b={b} {H}x{W} C={CHANNELS}: vs float64 max|dS| kernel {err.max().item():.3g}, plain "
            f"{plain_err.max().item():.3g}; worst kernel |dS| / allowed {(err / allowed).max().item():.3g}, plain "
            f"{(plain_err / allowed).max().item():.3g}; kernel vs plain max|dS| {(S1 - Sp).abs().max().item():.3g}, "
            f"max|S| {Sp.abs().max().item():.4g}; second run bit-identical")
        del raw, lab, S1, S2, Sp, S64

    # 5. the flagship step, kernels and plain versions
    t0 = time.time()
    step, model = build_inference_step(OBJECTS, K_POINTS, H, W, device="cuda", generator=torch.Generator().manual_seed(0))
    step_plain, _ = build_inference_step(
        OBJECTS, K_POINTS, H, W, device="cuda", generator=torch.Generator().manual_seed(0), plain=True
    )
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
        kernels[name]["launches"] = fn.launches
    if any(fn.launches == 0 for fn in launch_counters.values()):
        raise AssertionError(f"a kernel of the path never launched: { {n: f.launches for n, f in launch_counters.items()} }")
    for (label, img, kp3, cam), (poses, coords) in zip(cases, results):
        poses_p, coords_p = step_plain(img, kp3, cam, return_points=True)
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
        # against the plain version in phase 3, on planted problems at this batch's B = 256.
        e_k = reprojection_sq(poses, coords, kp3, cam)[available]
        e_p = reprojection_sq(poses_p, coords_p, kp3, cam)[available]
        kp3_w, cam_w = consistent_keypoints(coords, cam.shape[0])
        pts = coords.reshape(-1, K_POINTS, 2).flip(-1)
        pose_k = pose_matrix_from_p6d(solve_pnp(pts, kp3_w.reshape(-1, K_POINTS, 3), cam_w[0]))
        pose_p = pose_matrix_from_p6d(solve_pnp(pts, kp3_w.reshape(-1, K_POINTS, 3), cam_w[0], plain=True))
        r_k = reprojection_sq(pose_k, coords, kp3_w, cam_w)[available]
        r_p = reprojection_sq(pose_p, coords, kp3_w, cam_w)[available]
        ratio = (e_k / e_p.clamp(min=1e-12)).max().item() if available.any() else 1.0
        say("step", t0, f"{label}: poses {tuple(poses.shape)} finite, {int(available.sum())} available, the same for "
            f"both; max|d points| {(coords - coords_p).abs().max().item():.3g} px (rtol 1e-4, atol 5e-3); random "
            f"keypoints: worst reprojection kernel/plain {ratio:.4g}; consistent keypoints: exact (< 1e-4 px^2) "
            f"kernel {int((r_k < 1e-4).sum())}, plain {int((r_p < 1e-4).sum())}, kernel worse by > 0.1% on "
            f"{int((r_k > r_p * 1.001 + 1e-4).sum())}, plain worse on {int((r_p > r_k * 1.001 + 1e-4).sum())}")
    say("step", t0, f"launches on the main path: { {n: kernels[n]['launches'] for n in launch_counters} }")
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
    vote["ms"] = cuda_ms(lambda: voting_accumulate(out, lab_f, SEG_DIM, K_POINTS), 20)
    vote["plain_ms"] = cuda_ms(lambda: voting_accumulate_plain(out, lab_f, SEG_DIM, K_POINTS), 3)
    vote["library_ms"] = cuda_ms(lambda: einsum_sums(hot, dirs, conf, False), 3)
    v_bytes = lab_f.numel() * 4 + n_fg * 3 * K_POINTS * 4 + b * OBJECTS * K_POINTS * 6 * 4
    v_ops = n_fg * K_POINTS * 32  # direction, softplus, 6 features, 6 sums per pixel and keypoint
    vote["bound_ms"] = max(v_bytes / PEAK_BYTES_PER_S, v_ops / PEAK_F32_FLOP_PER_S) * 1e3
    vote["bound_by"] = "bytes" if v_bytes / PEAK_BYTES_PER_S >= v_ops / PEAK_F32_FLOP_PER_S else "operations"
    say("time", t0, f"voting b={b}: kernel {vote['ms']:.4f} ms, plain {vote['plain_ms']:.4f} ms, einsum form "
        f"{vote['library_ms']:.4f} ms, bound {vote['bound_ms']:.4f} ms ({vote['bound_by']}; {n_fg} labelled px)")

    Bp = pts2d.shape[0]
    pnp = kernels["pnp"]
    pnp["ms"] = cuda_ms(lambda: solve_pnp_kernel(pts2d, pts3d, K0), 20)
    pnp["plain_ms"] = cuda_ms(lambda: solve_pnp_plain(pts2d, pts3d, K0), 2)
    pnp["library_ms"] = None
    p_bytes = Bp * K_POINTS * 5 * 4 + 16 + Bp * 13 * 4
    p_ops = Bp * pnp_flops(K_POINTS, 10)
    pnp["bound_ms"] = max(p_bytes / PEAK_BYTES_PER_S, p_ops / PEAK_F32_FLOP_PER_S) * 1e3
    pnp["bound_by"] = "bytes" if p_bytes / PEAK_BYTES_PER_S >= p_ops / PEAK_F32_FLOP_PER_S else "operations"
    say("time", t0, f"pnp B={Bp}: kernel {pnp['ms']:.4f} ms, plain {pnp['plain_ms']:.4f} ms, "
        f"bound {pnp['bound_ms']:.6f} ms ({pnp['bound_by']})")

    meta = {
        "voting": ("casapose_tpu_torch/csrc/voting.cu", "casapose_tpu/ops/voting_kernel.py:103"),
        "pnp": ("casapose_tpu_torch/csrc/pnp.cu", "casapose_tpu/ops/pnp_kernel.py:489"),
    }
    line = []
    for name, (source, replaces) in meta.items():
        k = kernels[name]
        line.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": k["launches"], "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                     "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
                     "library_ms": k["library_ms"]})
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
