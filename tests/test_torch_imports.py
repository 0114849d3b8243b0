"""casapose_tpu_torch imports neither JAX nor the JAX package, and its entry points refuse a missing card.

The card's machine has no jax, flax, optax or h5py. A subprocess makes
those and ``casapose_tpu`` unimportable (``sys.modules[name] = None``), then
imports every module of the port. The entry points default to
``device="cuda"`` and must raise, not fall back, on a host without CUDA.
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_POISONED_IMPORT = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "h5py", "casapose_tpu"):
    sys.modules[name] = None  # any import of these now raises ImportError
import casapose_tpu_torch
names = [m.name for m in pkgutil.walk_packages(casapose_tpu_torch.__path__, "casapose_tpu_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "h5py", "casapose_tpu") and sys.modules[m] is not None)
assert not leaked, leaked
eval_slice = {"casapose_tpu_torch." + m for m in (
    "eval", "core.checkpoint", "data.mesh", "data.ndds", "data.pipeline", "losses.losses", "ops.vectorfield",
    "pose.bpnp", "pose.metrics", "pose.ransac", "utils.config", "utils.io")}
assert eval_slice <= set(names), sorted(eval_slice - set(names))
train_slice = {"casapose_tpu_torch." + m for m in (
    "train", "core.optimizer", "data.augment", "data.color", "losses.schedules")}
assert train_slice <= set(names), sorted(train_slice - set(names))
harness_slice = {"casapose_tpu_torch." + m for m in (
    "parallel.mesh", "utils.visualization", "utils.profiler", "ops.warp")}
assert harness_slice <= set(names), sorted(harness_slice - set(names))
serving_slice = {"casapose_tpu_torch." + m for m in (
    "data.image_only", "ops.quant", "core.export", "test_minimal", "export_model")}
assert serving_slice <= set(names), sorted(serving_slice - set(names))
tools_slice = {"casapose_tpu_torch." + m for m in (
    "ops.connected_components", "ops.cc_kernel", "data.raster", "dataset_converter", "convert_h5_weights")}
assert tools_slice <= set(names), sorted(tools_slice - set(names))
from casapose_tpu_torch.core.checkpoint import h5py_available
assert not h5py_available()
print(len(names))
"""

_ENTRY_POINTS_REFUSE = r"""
import torch
assert not torch.cuda.is_available()
from casapose_tpu_torch.entry import build_inference_step
from casapose_tpu_torch.eval import main, run_evaluation
from casapose_tpu_torch.train import run_training
from casapose_tpu_torch.models.registry import get_model
from casapose_tpu_torch.utils.config import parse_config
from casapose_tpu_torch.test_minimal import run_minimal
from casapose_tpu_torch.export_model import run_export
from casapose_tpu_torch.convert_h5_weights import main as convert_h5
opt = parse_config(["--estimate_confidence", "1", "--estimate_coords", "1", "--object", "obj_000001",
                    "--export_path", "unused.pt2"])
for call in (lambda: build_inference_step(), lambda: get_model("casapose_c_gcu5", 27, 9), lambda: run_evaluation(opt),
             lambda: main(["--estimate_confidence", "1", "--estimate_coords", "1", "--object", "obj_000001"]),
             lambda: run_training(opt), lambda: run_minimal(opt), lambda: run_export(opt),
             lambda: convert_h5(["in.h5", "out.npz", "--objects", "1"])):
    try:
        call()
    except RuntimeError as e:
        assert "CUDA" in str(e), e
    else:
        raise AssertionError("an entry point ran without CUDA and without device='cpu'")
print("refused")
"""


def _run(code):
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)


def test_every_module_imports_without_jax_or_the_jax_package():
    proc = _run(_POISONED_IMPORT)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 48  # every module of the slices was walked


def test_entry_points_raise_without_cuda():
    proc = _run(_ENTRY_POINTS_REFUSE)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("refused")


def test_package_sources_name_no_jax_import():
    pkg = os.path.join(ROOT, "casapose_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for fname in files:
            if fname.endswith(".py"):
                with open(os.path.join(dirpath, fname)) as f:
                    for line in f:
                        words = line.split()
                        if words[:1] in (["import"], ["from"]) and len(words) > 1:
                            root = words[1].split(".")[0]
                            assert root not in ("jax", "flax", "casapose_tpu"), f"{fname}: {line.strip()}"
