"""Export the inference pipeline as a ``torch.export`` program.

Counterpart of ``util_scripts/export_model.py``:

    python -m casapose_tpu_torch.export_model -c configs/config_8.ini \\
        --load_h5_weights 1 --load_h5_filename path/to/result_w_8 \\
        --imagesize_test 480 640 --batchsize_test 16 \\
        --export_path serving/casapose_480x640_b16.pt2 --export_platforms tpu [--device cpu]

writes the program of ``core/export.py::export_inference`` (network -> LS
voting -> PnP, weights inside) for the batch and image size given and
prints its size and shapes. ``--export_platforms`` names the devices, one
program each: ``cpu`` is the CPU, any accelerator name (the default ``tpu``,
``gpu``, ``cuda``) the card; with more than one device each program goes to
``<export_path stem>.<device><suffix>``. ``--device`` is where the model is
built and its weights loaded (the card unless ``cpu``).

Load and call (needs torch and ``casapose_tpu_torch.ops``, which registers
the program's custom operators):

    from casapose_tpu_torch.core.export import load_exported
    poses = load_exported(open(PATH, "rb").read())(img, keypoints3d, camera)
"""

import argparse
import os
import sys
import time

import torch

from casapose_tpu_torch.core.device import resolve_device
from casapose_tpu_torch.core.export import export_inference
from casapose_tpu_torch.eval import load_weights_from_opt
from casapose_tpu_torch.models.registry import build_model_from_opt


def export_devices(platforms):
    """The devices of ``--export_platforms``, in order, without repeats: 'cpu' -> cpu, any other name -> cuda."""
    devices = []
    for name in (p.strip() for p in platforms.split(",")):
        dev = "cpu" if name == "cpu" else "cuda"
        if name and dev not in devices:
            devices.append(dev)
    return devices


def run_export(opt, device="cuda"):
    """Export one program per device of ``opt.export_platforms``; returns {device: path}."""
    if not opt.export_path:
        raise SystemExit("--export_path is required")
    objects = [o for o in (opt.object or "").split(",") if o]
    if not objects:
        raise SystemExit("--object must list the objects of interest")
    devices = export_devices(opt.export_platforms)
    if not devices:
        raise SystemExit("--export_platforms names no device")
    no_objects = len(objects)
    model = build_model_from_opt(opt, no_objects, device=resolve_device(device),
                                 generator=torch.Generator().manual_seed(int(opt.manualseed)))
    load_weights_from_opt(opt, model)
    h, w = (int(x) for x in opt.imagesize_test)
    batch = max(int(getattr(opt, "batchsize_test", 1)), 1)
    stem, suffix = os.path.splitext(opt.export_path)
    written = {}
    for dev in devices:
        path = opt.export_path if len(devices) == 1 else f"{stem}.{dev}{suffix}"
        t0 = time.time()
        blob = export_inference(
            model.to(resolve_device(dev)), batch, h, w, no_objects, opt.no_points, device=dev,
            estimate_confidence=bool(opt.estimate_confidence),
            filter_estimates=bool(opt.confidence_filter_estimates),
            choose_second=bool(opt.confidence_choose_second),
            cc_downsample=int(getattr(opt, "cc_filter_downsample", 4)),
        )
        seconds = time.time() - t0
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "wb") as f:
            f.write(blob)
        print(f"wrote {path}: {len(blob) / 1e6:.1f} MB, device {dev} (--export_platforms {opt.export_platforms}: "
              f"'cpu' is the CPU, any other name the card), input ({batch},{h},{w},3) -> poses "
              f"({batch},{no_objects},1,3,4), exported in {seconds:.1f} s")
        written[dev] = path
    return written


def main(argv=None):
    """``python -m casapose_tpu_torch.export_model``: the flags of ``util_scripts/export_model.py``, plus
    ``--device``."""
    from casapose_tpu_torch.utils.config import parse_config

    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda", help="where the model is built and loaded: cuda (default) or cpu")
    args, rest = pre.parse_known_args(argv)
    run_export(parse_config(rest), device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
