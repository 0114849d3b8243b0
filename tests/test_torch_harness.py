"""The port's evaluation harness against the JAX package's, on the CPU.

``python -m casapose_tpu_torch.eval --device cpu`` and the JAX harness
(``casapose_tpu/eval.py::run_evaluation``, what ``test_casapose.py`` runs)
evaluate one ``tools/synthetic_scene.py`` scene (2 objects, 5 images of
240x320, evaluated at 64x80, batch 2: two full batches and a tail) with
the same weights, written as the JAX package's ``.npz`` export. Their CSVs
must have the same header and rows; the printed losses agree to rtol 1e-4
(float32 sums in another order; the total loss is printed with 15 digits,
so its printed digits cannot all agree), the 2D/3D columns are equal as
text, and the ``time`` column is not compared. Random weights give no valid
pose, so the BOP pose export is compared by its files and its
scene / image / object columns. The host modules the harness copied from
the JAX package (config parse, loader, pose export, weight import) are held
against their originals here as well.
"""

import csv
import glob
import os
import subprocess
import sys

import numpy as np
import pytest

from tests.torch_parity import calibrated_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 64, 80


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    from tools.synthetic_scene import make_meshes, make_scene, object_names

    root = tmp_path_factory.mktemp("harness")
    make_meshes(str(root / "models"))
    make_scene(str(root / "data" / "000000"), str(root / "models"), n_images=5)
    return root, object_names()


@pytest.fixture(scope="module")
def weights(scene):
    """The JAX model's variables (BatchNorm statistics of one pass) as the JAX package's .npz export."""
    from casapose_tpu.models.registry import get_model as jax_get_model

    root, _ = scene
    jm = jax_get_model("casapose_c_gcu5", ver_dim=27, seg_dim=3)
    flat = calibrated_variables(jm, np.random.default_rng(0).normal(size=(2, H, W, 3)).astype(np.float32))
    np.savez(str(root / "w.npz"), **flat)
    return str(root / "w"), flat


def _flags(root, objects, weights_path, tag):
    return [
        "--data", str(root / "data_none"), "--datatest", str(root / "data"), "--datameshes", str(root / "models"),
        "--object", ",".join(objects), "--modelname", "casapose_c_gcu5", "--estimate_confidence", "1",
        "--estimate_coords", "1", "--no_points", "9", "--imagesize_test", str(H), str(W),
        "--train_vectors_with_ground_truth", "1", "--min_object_size_test", "1", "--workers", "1",
        "--prefetch", "1", "--manualseed", "3", "--batchsize_test", "2", "--write_poses", "1",
        "--load_h5_weights", "1", "--load_h5_filename", weights_path, "--keypoint_loss_weight", "0.007",
        "--proxy_loss_weight", "0.015", "--outf", str(root / f"out_{tag}"), "--evalf", str(root / f"eval_{tag}"),
    ]


@pytest.fixture(scope="module")
def harness_runs(scene, weights):
    from casapose_tpu.eval import run_evaluation
    from casapose_tpu.utils.config import parse_config

    root, objects = scene
    run_evaluation(parse_config(_flags(root, objects, weights[0], "jax")))
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "casapose_tpu_torch.eval", *_flags(root, objects, weights[0], "port"), "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "loaded 148 arrays" in proc.stdout and "== TEST == Finished" in proc.stdout
    return root / "eval_jax", root / "eval_port"


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


@pytest.mark.parametrize("name, time_col", [("loss_test_eval.csv", 6), ("test_summary_eval.csv", 5)])
def test_csvs_match_jax(harness_runs, name, time_col):
    want, got = (_rows(os.path.join(d, name)) for d in harness_runs)
    assert got[0] == want[0]  # header
    assert len(got) == len(want) == (4 if name.startswith("loss") else 2)
    for g, w in zip(got[1:], want[1:]):
        assert len(g) == len(w)
        first_loss = 1 if name.startswith("loss") else 0
        assert g[:first_loss] == w[:first_loss]  # batch id
        np.testing.assert_allclose([float(x) for x in g[first_loss:time_col]], [float(x) for x in w[first_loss:time_col]],
                                   rtol=1e-4)
        assert g[time_col + 1 :] == w[time_col + 1 :]  # the 2D / 3D valid columns, as printed


def test_bop_pose_export_matches_jax(harness_runs):
    want, got = ([os.path.relpath(p, d) for p in sorted(glob.glob(os.path.join(d, "poses_out", "*", "*.txt")))]
                 for d in harness_runs)
    assert got == want and len(got) == 6
    want, got = (_rows(os.path.join(d, "poses_out", "bop_evaluation.csv")) for d in harness_runs)
    assert [r[:3] for r in got] == [r[:3] for r in want] and len(got) == 11


def test_config_parse_matches_jax():
    from casapose_tpu.utils.config import parse_config as jax_parse
    from casapose_tpu_torch.utils.config import parse_config

    argv = ["-c", os.path.join(ROOT, "configs", "config_8.ini"), "--batchsize_test", "32", "--eval_chunk", "8",
            "--imagesize_test", "240", "320", "--datatest", "/data/x", "--objects_to_copy_list", ""]
    want, got = vars(jax_parse(argv)), vars(parse_config(argv))
    assert set(got) == set(want)
    for key in want:
        if isinstance(want[key], np.ndarray):
            np.testing.assert_array_equal(got[key], want[key])
        else:
            assert got[key] == want[key], key


def test_loader_batches_match_jax(scene):
    """VectorfieldDataset + its loader, eval settings: every array of every batch equal, a tail batch included."""
    from casapose_tpu.data.ndds import VectorfieldDataset as JaxDataset
    from casapose_tpu_torch.data.ndds import VectorfieldDataset

    root, objects = scene
    kw = dict(root=str(root / "data"), path_meshes=str(root / "models"), color_input=True, no_points=9,
              objectsofinterest=objects, noise=0.00001, random_translation=(0, 0), random_rotation=0, random_crop=False)
    batches = []
    for cls in (JaxDataset, VectorfieldDataset):
        ds = cls(**kw)
        it, n = ds.generate_dataset(2, 1, 1, (H, W), 1.0, 1, len(objects), shuffle=False, seed=3, drop_remainder=False)
        batches.append(([it.get_next() for _ in range(n)], ds.generate_object_vertex_array()))
        it.close()
    (want, want_verts), (got, got_verts) = batches
    assert len(got) == len(want) == 3 and got[-1]["img"].shape[0] == 1
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in w:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    for g, w in zip(got_verts, want_verts):
        np.testing.assert_array_equal(g, w)


def test_write_poses_matches_jax(tmp_path):
    from casapose_tpu.utils.io import write_poses as jax_write
    from casapose_tpu_torch.utils.io import write_poses

    rng = np.random.default_rng(4)
    gt = rng.normal(size=(2, 1, 3, 4)).astype(np.float32)
    gt[1] = 0.0
    est = rng.normal(size=(2, 3, 4)).astype(np.float32)
    for fn, d in ((jax_write, tmp_path / "jax"), (write_poses, tmp_path / "port")):
        for i in range(2):
            fn(gt, est, ["obj_000001", "obj_000005"], np.asarray([b"000000_000000_00000" + str(i).encode()]),
               str(d) + "/", time_needed=0.25)
    files = sorted(os.path.relpath(p, tmp_path / "jax") for p in glob.glob(str(tmp_path / "jax" / "**" / "*.*"), recursive=True))
    assert len(files) == 7
    for rel in files:
        assert (tmp_path / "port" / rel).read_text() == (tmp_path / "jax" / rel).read_text(), rel


def test_load_weights_npz(weights, tmp_path):
    """The .npz export loads by name through the weight bridge; unknown names and wrong shapes are skipped."""
    import torch

    from casapose_tpu_torch.core.checkpoint import load_weights_npz
    from casapose_tpu_torch.models.registry import get_model
    from tests.torch_parity import torch_model

    path, flat = weights
    extra = dict(flat)
    extra["params/not_a_layer/kernel"] = np.zeros((3, 3), np.float32)
    bad = next(k for k in flat if k.endswith("pv_final_conv_vertex/kernel"))
    extra[bad] = np.zeros((1, 1, 32, 5), np.float32)
    np.savez(str(tmp_path / "extra.npz"), **extra)
    model = get_model("casapose_c_gcu5", ver_dim=27, seg_dim=3, device="cpu")
    n, skipped = load_weights_npz(path + ".npz", model)
    assert n == len(flat) == 148 and skipped == []
    want = torch_model(flat, 27, 3).state_dict()
    for key, value in model.state_dict().items():
        assert torch.equal(value, want[key]), key
    n, skipped = load_weights_npz(str(tmp_path / "extra.npz"), model)
    assert n == 147 and sorted(skipped) == sorted(["params/not_a_layer/kernel", bad])
