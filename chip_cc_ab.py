#!/usr/bin/env python3
"""Two builds of the CC labelling kernel on one CUDA card, in alternation within one process: this checkout's
casapose_tpu_torch/csrc/cc.cu against the cc.cu of another csrc directory (a parent commit's, unpacked with
git archive).

    python3 chip_cc_ab.py OTHER_CSRC_DIR      # from the repository root; needs one card

1. The kernel alone: kernel_ms (chip_smoke.kernel_ms, a CUDA graph of wrapper calls) on the main path's masks
   (chip_smoke.py phase 5's b=32 noise batch: 256 masks of 120x160, and its first 8, the b=1 case), on the same
   batch's 480x640 class masks and on the two serpentines of phase 27, in the order other, this, this, other; each
   build's labels and sweeps equal to the plain loop's.
2. Inside the steps: the package's CC library swapped between the two builds, 10 pairs alternating which runs
   first: the evaluation step (phase 8's batches) at b=1 and b=32 in ms/image, the inference step at b=1 and b=32
   and its "class masks + CC filter" stage (phase 6's inputs), between CUDA events; medians, quartiles and the
   pairs in which this build's time is the lower.
"""

import ctypes
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
PAIRS = 10


def main(other_csrc):
    import torch

    if not torch.cuda.is_available():
        print("chip_cc_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from casapose_tpu_torch.core.numerics import f32_precision
    from casapose_tpu_torch.entry import build_inference_step
    from casapose_tpu_torch.ops import _build
    from casapose_tpu_torch.ops.cc_kernel import connected_components_plain
    from casapose_tpu_torch.ops.voting import class_masks, filtered_labels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    this = _build.load("cc")
    other_so = os.path.join(_build.BUILD_DIR, "other", "cc.so")
    os.makedirs(os.path.dirname(other_so), exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", other_so, os.path.join(other_csrc, "cc.cu")],
                   check=True, capture_output=True)
    other = ctypes.CDLL(other_so)
    other.cc_label.argtypes, other.cc_label.restype = this.cc_label.argtypes, this.cc_label.restype
    libs = {"other": other, "this": this}
    dev = torch.device("cuda")

    def run(lib, fg):
        m, h, w = fg.shape
        labels = torch.empty((m, h, w), dtype=torch.int32, device=dev)
        sweeps = torch.zeros((m,), dtype=torch.int32, device=dev)
        rc = lib.cc_label(ctypes.c_void_p(fg.data_ptr()), ctypes.c_void_p(labels.data_ptr()),
                          ctypes.c_void_p(sweeps.data_ptr()), m, h, w, 64,
                          ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if rc:
            raise RuntimeError(f"cc_label: CUDA error {rc}")
        return labels, sweeps

    # Phase 5's model and draws (its b=32 noise image is the main path's batch), phase 6's full-resolution masks.
    step, model = build_inference_step(cs.OBJECTS, cs.K_POINTS, cs.H, cs.W, device="cuda",
                                       generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    inputs = {}
    for b in (1, 32):
        kp3 = torch.from_numpy(rng.uniform(-0.05, 0.05, (b, cs.OBJECTS, 1, cs.K_POINTS, 3)).astype(np.float32)).to(dev)
        cam = torch.tensor(cs.CAMERA, device=dev).expand(b, 3, 3).contiguous()
        img = torch.from_numpy(rng.normal(size=(b, cs.H, cs.W, 3)).astype(np.float32)).to(dev)
        with torch.no_grad(), f32_precision():
            seg = model(img)[..., : cs.SEG_DIM]
        inputs[b] = (img, kp3, cam, seg)
    img, kp3, cam, seg = inputs[32]
    with cs.cc_recording() as records:
        step(img, kp3, cam)
    main_fg = records[-1][0]
    with torch.no_grad():
        labels, _ = class_masks(seg, torch.float32, True)
    full_fg = (labels[..., None] == torch.arange(1, cs.SEG_DIM, device=dev)).permute(0, 3, 1, 2)
    full_fg = full_fg.reshape(-1, cs.H, cs.W).contiguous()
    cases = [("b=32, 256 masks of 120x160", main_fg), ("b=1, 8 masks of 120x160", main_fg[:8].contiguous()),
             ("full resolution, 256 masks of 480x640", full_fg),
             ("serpentine 120x160", torch.from_numpy(cs.serpentine(120, 160, True)).to(dev)),
             ("serpentine 480x640", torch.from_numpy(cs.serpentine(480, 640)).to(dev))]
    for name, fg in cases:
        plain, n = connected_components_plain(fg, return_sweeps=True)
        small = fg.shape[1] * fg.shape[2] <= 120 * 160
        times = []
        for build in ("other", "this", "this", "other"):
            got, sweeps = run(libs[build], fg)
            if not (torch.equal(got, plain) and int(sweeps.max()) == n):
                raise AssertionError(f"{build} build, {name}: labels or sweeps differ from the plain loop's")
            ms = cs.kernel_ms(build, lambda: run(libs[build], fg), iters=20 if small else 4, reps=5 if small else 1)
            times.append(f"{build} {ms:.4f}")
        print(f"kernel_ms {name} ({n} sweeps; labels and sweeps equal to the plain loop's): {', '.join(times)}",
              flush=True)
    del main_fg, full_fg, labels, records
    torch.cuda.empty_cache()

    kernels = {name: {"max_abs_err": 0.0, "launches_by_path": {}, "sweeps_by_path": {}}
               for name in ("voting", "pnp", "cc")}
    _, eval_step, batches = cs.phase_eval(dev, kernels)

    def measure():
        out = {}
        for b in (1, 32):
            img, kp3, cam, seg = inputs[b]
            out[f"eval step b={b}, ms/image"] = cs.cuda_ms(lambda: eval_step(batches[b]), 5 if b == 1 else 2) / b
            out[f"inference step b={b}, ms"] = cs.cuda_ms(lambda: step(img, kp3, cam), 10 if b == 1 else 3, warmup=2)
            with torch.no_grad(), f32_precision():
                out[f"class masks + CC filter b={b}, ms"] = cs.cuda_ms(
                    lambda: filtered_labels(*class_masks(seg, torch.float32, True)), 10)
        return out

    results = {"other": [], "this": []}
    for i in range(PAIRS):
        for build in ("other", "this") if i % 2 == 0 else ("this", "other"):
            _build._libs["cc"] = libs[build]  # the wrapper's library: every CC launch of the steps goes to this build
            results[build].append(measure())
    _build._libs["cc"] = this
    for key in results["this"][0]:
        o, t = ([r[key] for r in results[build]] for build in ("other", "this"))
        print(f"{key}: other median {np.median(o):.3f} (quartiles {np.percentile(o, 25):.3f}-"
              f"{np.percentile(o, 75):.3f}), this median {np.median(t):.3f} (quartiles {np.percentile(t, 25):.3f}-"
              f"{np.percentile(t, 75):.3f}); this lower in {sum(a < b for a, b in zip(t, o))} of {PAIRS} pairs",
              flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1]))
