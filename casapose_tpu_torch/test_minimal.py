"""Minimal inference latency benchmark (network -> LS voting -> PnP).

Counterpart of ``util_scripts/test_minimal.py``:

    python -m casapose_tpu_torch.test_minimal -c configs/config_8.ini --datatest ... --datameshes ... \\
        --object ... [--load_h5_weights 1 --load_h5_filename ...] [--quantized_inference int8] [--device cpu]

streams the images of ``--datatest`` (``data/image_only.py``, one a batch)
through the inference step (``core/export.py::build_serving_fn``: filtered
LS voting from the raw output, PnP), with keypoints and camera from one batch
of the dataset, times each batch after ``torch.cuda.synchronize()``, writes
``<evalf>/speed_eval.csv`` and prints the mean over batches 10+ (1+ for short
runs), as the JAX script does. It runs on the card unless ``--device cpu``
is given, at ``--matmul_precision``; ``--quantized_inference int8`` runs the
convolutions int8-quantized.
"""

import argparse
import contextlib
import os
import sys
import time

import numpy as np
import torch

from casapose_tpu_torch.core.device import resolve_device
from casapose_tpu_torch.core.export import build_serving_fn
from casapose_tpu_torch.core.numerics import matmul_precision
from casapose_tpu_torch.data.image_only import ImageOnlyDataset
from casapose_tpu_torch.data.ndds import VectorfieldDataset
from casapose_tpu_torch.eval import load_weights_from_opt
from casapose_tpu_torch.models.registry import build_model_from_opt
from casapose_tpu_torch.ops.quant import quantized_convs


def run_minimal(opt, device="cuda"):
    """Time the inference step on every image of ``opt.datatest``; returns the per-batch seconds."""
    dev = resolve_device(device)
    objectsofinterest = [x.strip() for x in opt.object.split(",")]
    no_objects = len(objectsofinterest)
    k = opt.no_points

    stream, _ = ImageOnlyDataset(root=opt.datatest).generate_dataset(batchsize=1)
    meta_dataset = VectorfieldDataset(
        root=opt.datatest, path_meshes=opt.datameshes, path_filter_root=opt.datatest_path_filter,
        color_input=opt.color_dataset, no_points=k, objectsofinterest=objectsofinterest, random_translation=(0, 0),
        random_rotation=0, random_crop=False,
    )
    it, _ = meta_dataset.generate_dataset(1, 1, 2, opt.imagesize_test, 1.0, 2, no_objects, shuffle=False)
    meta = it.get_next()
    it.close()
    keypoints3d = torch.as_tensor(meta["keypoints3d"], device=dev)
    camera = torch.as_tensor(meta["camera"], device=dev)

    model = build_model_from_opt(opt, no_objects, device=dev, generator=torch.Generator().manual_seed(int(opt.manualseed)))
    load_weights_from_opt(opt, model)
    serve = build_serving_fn(model, no_objects, k)
    convs = quantized_convs if getattr(opt, "quantized_inference", "") == "int8" else contextlib.nullcontext
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    os.makedirs(opt.evalf, exist_ok=True)
    csv_path = os.path.join(opt.evalf, "speed_eval.csv")
    with open(csv_path, "w") as f:
        f.write("batchid,time\n")
    times = []
    for batch_idx, img in enumerate(stream):
        img = torch.from_numpy(img).to(dev)
        sync()
        t0 = time.time()
        with torch.no_grad(), matmul_precision(opt.matmul_precision), convs():
            serve(img, keypoints3d, camera)
        sync()
        dt = time.time() - t0
        times.append(dt)
        with open(csv_path, "a") as f:
            f.write(f"{batch_idx + 1},{dt:.6f}\n")

    # Short runs: skip the first batch instead of averaging it in, as the JAX script does.
    mean_time = float(np.mean(times[10:])) if len(times) > 10 else float(np.mean(times[1:])) if len(times) > 1 else float(times[0])
    print(f"mean time (batches 10+): {mean_time:.6f} s -> {1.0 / mean_time:.2f} images/sec")
    with open(csv_path, "a") as f:
        f.write(f"mean,{mean_time:.6f}\n")
    return times


def main(argv=None):
    """``python -m casapose_tpu_torch.test_minimal``: the flags of ``util_scripts/test_minimal.py``, plus
    ``--device``."""
    from casapose_tpu_torch.utils.config import parse_config

    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args, rest = pre.parse_known_args(argv)
    run_minimal(parse_config(rest), device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
