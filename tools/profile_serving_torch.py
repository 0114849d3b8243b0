#!/usr/bin/env python3
"""Where the port's serving extras spend their time on one CUDA card (casapose_tpu_torch, PyTorch).

    python3 tools/profile_serving_torch.py      # from the repository root; needs a card

Prints the card's ``nvidia-smi`` name and power limit, then:
  1. the flagship network (casapose_c_gcu5, resnet18, 8 objects, 480x640,
     batch 32, random weights of seed 0) with int8 convolutions and in
     float32: device time per call and the kernels that take it, from
     ``torch.profiler``;
  2. the float32 serving function at batch 1 live and as an exported
     program (core/export.py): device time per call and its kernels, beside
     the host-clock milliseconds per call after a synchronise;
  3. the ``bf16c`` voting form's sums on that network's batch-32 output: the
     bfloat16-rounded operands summed by ``torch.bmm(..., out_dtype=float32)``
     and by a float32 product, each against the float64 sums of the same
     operands (the largest error over each row's largest sum).
"""

import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, OBJECTS, K = 480, 640, 8, 9
CAMERA = [[572.4, 0.0, 325.3], [0.0, 573.5, 242.0], [0.0, 0.0, 1.0]]


def device_profile(fn, iters, label, top=12):
    """Device ms per call of ``fn()`` and its ``top`` kernels by device time, from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in events) / 1e3 / iters
    print(f"== {label}: device time {total:.3f} ms per call", flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  {e.self_device_time_total / 1e3 / iters:9.3f} ms x{e.count // iters:5d}  {e.key[:110]}", flush=True)


def host_ms(fn, iters):
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.time() - t0) * 1e3 / iters


def main():
    import torch

    if not torch.cuda.is_available():
        print("profile_serving_torch: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from casapose_tpu_torch.core.export import build_serving_fn, export_inference, load_exported
    from casapose_tpu_torch.core.numerics import divide_no_nan, f32_precision
    from casapose_tpu_torch.entry import build_inference_step
    from casapose_tpu_torch.ops import _build
    from casapose_tpu_torch.ops.quant import quantized_apply
    from casapose_tpu_torch.ops.voting import _features, class_masks

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    _build.build()
    _, model = build_inference_step(OBJECTS, K, H, W, device="cuda", generator=torch.Generator().manual_seed(0))
    img = torch.from_numpy(np.random.default_rng(0).normal(size=(32, H, W, 3)).astype(np.float32)).cuda()

    # 1. the network, int8 and float32
    with torch.no_grad(), f32_precision():
        device_profile(lambda: quantized_apply(model, img), 2, "int8 network b=32")
        device_profile(lambda: model(img), 2, "float32 network b=32")

    # 2. the serving function, live and exported
    img1 = img[:1].contiguous()
    kp3 = torch.from_numpy(np.random.default_rng(1).uniform(-0.05, 0.05, (1, OBJECTS, 1, K, 3)).astype(np.float32)).cuda()
    cam = torch.tensor(CAMERA, device="cuda")[None]
    serve = build_serving_fn(model, OBJECTS, K)
    program = load_exported(export_inference(model, 1, H, W, OBJECTS, K, device="cuda"))

    def live():
        with torch.no_grad(), f32_precision():
            return serve(img1, kp3, cam)

    def exported():
        return program(img1, kp3, cam)

    for label, fn in (("live serving function b=1", live), ("exported program b=1", exported)):
        device_profile(fn, 5, label, top=6)
        print(f"   host clock {host_ms(fn, 10):.3f} ms per call", flush=True)

    # 3. bf16c's sums: bmm with a float32 output against a float32 product of the rounded operands
    with torch.no_grad(), f32_precision():
        out = model(img)
        seg, dirs, conf = out[..., : OBJECTS + 1], out[..., OBJECTS + 1 : OBJECTS + 1 + 2 * K], out[..., OBJECTS + 1 + 2 * K :]
        _, hot = class_masks(seg, torch.float32, True)
        b, h, w, oc = hot.shape
        wgt, a, bb, d, cy, cx = _features(dirs, conf, False, h, w)
        inv_m0 = divide_no_nan(torch.ones((), device=hot.device), hot.sum(dim=(1, 2)))
        cyp = cy - torch.einsum("bhwo,bo->bhw", hot, torch.sum(hot * cy, dim=(1, 2)) * inv_m0)[..., None]
        cxp = cx - torch.einsum("bhwo,bo->bhw", hot, torch.sum(hot * cx, dim=(1, 2)) * inv_m0)[..., None]
        feats = torch.cat([f * wgt for f in (a, bb, d, a * cyp + bb * cxp, bb * cyp + d * cxp)] + [wgt], dim=-1)
        hot16 = hot.to(torch.bfloat16).reshape(b, h * w, oc).transpose(1, 2)
        feats16 = feats.to(torch.bfloat16).reshape(b, h * w, 6 * K)
        exact = torch.bmm(hot16.double(), feats16.double())
        for label, S in (("bmm(out_dtype=float32)", torch.bmm(hot16, feats16, out_dtype=torch.float32)),
                         ("float32 product", torch.bmm(hot16.float(), feats16.float()))):
            rel = ((S.double() - exact).abs() / exact.abs().amax(-1, keepdim=True).clamp(min=1e-30)).max().item()
            print(f"== bf16c sums b=32, {label}: max |S - S64| / the row's max |S64| {rel:.3g}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
