"""``--profile_dir`` in both harnesses of the port, and ``--save_eval_batches`` in the eval harness, on the CPU.

The trainer (``run_training``, 1 epoch of 2 steps on a ``tools/synthetic_scene.py``
scene) traces its steps ``min(10, n - 1)`` to ``+5`` of the first epoch,
the eval harness (``run_evaluation``, 4 batches of 1) its batches 1-5, as
the JAX harnesses do; each writes a torch.profiler Chrome trace under the
directory, which must hold the network's operators, and prints "wrote
profiler trace to <dir>". The eval run also writes the visual dumps of
``--save_eval_batches``: the same files as the JAX harness writes on the
same scene and weights (the writers' pixels are held in
tests/test_torch_visualization.py).
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest

from tests.torch_parity import calibrated_variables, single_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 32, 48


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    from tools.synthetic_scene import make_meshes, make_scene, object_names

    root = tmp_path_factory.mktemp("profile")
    make_meshes(str(root / "models"))
    make_scene(str(root / "data" / "000000"), str(root / "models"), n_images=4)
    return root, object_names()


def _run(run, flags):
    from casapose_tpu_torch.utils.config import parse_config

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = run(parse_config(flags), device="cpu")
    return result, out.getvalue()


def _trace_ops(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return {e.get("name", "") for e in events}


def test_trainer_writes_a_trace(scene, tmp_path):
    from casapose_tpu_torch.train import run_training

    root, objects = scene
    prof = tmp_path / "prof"
    flags = ["-c", os.path.join(ROOT, "configs", "config_8.ini"), "--objects_to_copy_list", "", "--data",
             str(root / "data"), "--datatest", "", "--datameshes", str(root / "models"), "--object", ",".join(objects),
             "--imagesize", str(H), str(H), "--batchsize", "2", "--train_validation_split", "1.0", "--epochs", "1",
             "--workers", "1", "--pretrained", "0", "--outf", str(tmp_path / "out"), "--profile_dir", str(prof)]
    state, printed = _run(run_training, flags)
    assert state.step == 2 and f"wrote profiler trace to {prof}" in printed
    ops = _trace_ops(prof / "train_trace.json")
    assert {"aten::convolution", "aten::einsum"} <= ops  # the step's network and its losses


@pytest.fixture(scope="module")
def eval_runs(scene):
    """The eval harness of both packages on the scene with the same weights, with --save_eval_batches."""
    from casapose_tpu.eval import run_evaluation as jax_run_evaluation
    from casapose_tpu.models.registry import get_model as jax_get_model
    from casapose_tpu.utils.config import parse_config as jax_parse
    from casapose_tpu_torch.eval import run_evaluation

    root, objects = scene
    jm = jax_get_model("casapose_c_gcu5", ver_dim=27, seg_dim=3)
    flat = calibrated_variables(jm, np.random.default_rng(0).normal(size=(1, H, W, 3)).astype(np.float32))
    np.savez(str(root / "w.npz"), **flat)

    def flags(tag):
        return ["--data", str(root / "none"), "--datatest", str(root / "data"), "--datameshes", str(root / "models"),
                "--object", ",".join(objects), "--modelname", "casapose_c_gcu5", "--estimate_confidence", "1",
                "--estimate_coords", "1", "--no_points", "9", "--imagesize_test", str(H), str(W),
                "--train_vectors_with_ground_truth", "1", "--min_object_size_test", "1", "--workers", "1",
                "--batchsize_test", "1", "--load_h5_weights", "1", "--load_h5_filename", str(root / "w"),
                "--save_eval_batches", "1", "--outf", str(root / f"out_{tag}"), "--evalf", str(root / f"eval_{tag}")]

    with contextlib.redirect_stdout(io.StringIO()):
        jax_run_evaluation(jax_parse(flags("jax")))
    result, printed = _run(run_evaluation, flags("port") + ["--profile_dir", str(root / "prof")])
    return root, result, printed


def test_eval_harness_writes_a_trace(eval_runs):
    root, result, printed = eval_runs
    assert result["total_images"] == 4 and f"wrote profiler trace to {root / 'prof'}" in printed
    assert "aten::convolution" in _trace_ops(root / "prof" / "eval_trace.json")


def test_eval_harness_writes_the_jax_harness_visual_dumps(eval_runs):
    root, _, _ = eval_runs

    def files(tag):
        base = root / f"eval_{tag}" / "visual_batch_eval_mask"
        return sorted(str(p.relative_to(base)) for p in base.rglob("*.png"))

    got = files("port")
    assert got == files("jax")
    assert {"0000_est_mask.png", "0003_poses.png"} <= set(got)
    per_image = [p for p in got if p.endswith("proxy_summary.png")]
    assert len(per_image) == 4
    assert sum(p.endswith(tuple(f"proxy_error_{i}.png" for i in range(9))) for p in got) == 4 * 9
