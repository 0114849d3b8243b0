"""Convert reference Keras ``.h5`` weights to the JAX package's ``.npz`` format, with the port.

    python -m casapose_tpu_torch.convert_h5_weights result_w_8.h5 result_w_8.npz \
        --objects 8 [--no_points 9] [--modelname casapose_c_gcu5] [--device cpu]

The flags of ``util_scripts/convert_h5_weights.py``, plus ``--device``. The
model of the port's registry (seeded random weights) takes the ``.h5``'s
arrays through ``core/checkpoint.py::import_keras_h5`` and is written by
``save_weights_npz`` under the JAX package's names, the ``.npz`` that both
packages' harnesses load (``--load_h5_weights 1``). Reading ``.h5`` needs
h5py, which the card's machine does not have: convert where h5py is
installed (``--device cpu``) and copy the ``.npz``. ``--height`` and
``--width`` are accepted for the JAX script's command lines; the port's
model takes no input shape.
"""

import argparse
import sys

import torch

from casapose_tpu_torch.core.checkpoint import import_keras_h5, save_weights_npz
from casapose_tpu_torch.core.device import resolve_device
from casapose_tpu_torch.models.registry import get_model


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Convert reference Keras .h5 weights to the .npz format (needs h5py, which the card's "
                    "machine lacks: run it with --device cpu where h5py is installed).")
    parser.add_argument("h5_in")
    parser.add_argument("npz_out")
    parser.add_argument("--objects", type=int, required=True)
    parser.add_argument("--no_points", type=int, default=9)
    parser.add_argument("--modelname", default="casapose_c_gcu5")
    parser.add_argument("--estimate_confidence", type=int, default=1)
    parser.add_argument("--height", type=int, default=480, help="unused: the port's model takes no input shape")
    parser.add_argument("--width", type=int, default=640, help="unused: the port's model takes no input shape")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    dev = resolve_device(args.device)
    ver_dim = args.no_points * 2 + (args.no_points if args.estimate_confidence else 0)
    model = get_model(args.modelname, ver_dim=ver_dim, seg_dim=1 + args.objects, device=dev,
                      generator=torch.Generator().manual_seed(0))
    loaded, skipped = import_keras_h5(args.h5_in, model, verbose=True)
    print(f"loaded {loaded} arrays; {len(skipped)} h5 datasets had no matching parameter")
    save_weights_npz(args.npz_out, model)
    print(f"wrote {args.npz_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
