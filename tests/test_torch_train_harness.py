"""The port's trainer (``python -m casapose_tpu_torch.train --device cpu``) against the JAX trainer, on the CPU.

Both train casapose_c_gcu5 on one ``tools/synthetic_scene.py`` scene (2
objects, 4 images of 240x320, 32x32 crops, batch 2: one epoch of 2 batches,
then a validation with pose estimation on a second scene of 2 images), from the same
initial weights (the JAX model's, with the BatchNorm statistics of one
pass, ``tests/torch_parity.py::calibrated_variables``, so that the
validation's running statistics keep activations at a trained network's
scale; as its ``.npz`` export through ``--load_h5_weights 1``), with ``pretrained 0``, ``noise 0`` and
``use_imgaug 1`` (the host augmentation, byte for byte the same in both),
and ``saveinterval`` above ``epochs``. The four CSVs have the same headers
and the same number of rows; the loss columns agree to rtol 1e-3 (the
keypoint loss after the first Adam step to rtol 1e-2, see
tests/test_torch_train_step.py), the learning rate and the 2D/3D columns
are equal as text. The resume from the port's own checkpoint:
tests/test_torch_train_resume.py.
"""

import csv
import os
import subprocess
import sys

import numpy as np
import pytest

from tests.torch_parity import calibrated_variables, jax_train_variables
from tests.torch_parity import single_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 32


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    from tools.synthetic_scene import make_meshes, make_scene, object_names

    root = tmp_path_factory.mktemp("train_harness")
    make_meshes(str(root / "models"))
    make_scene(str(root / "data" / "000000"), str(root / "models"), n_images=4)
    make_scene(str(root / "test" / "000000"), str(root / "models"), n_images=2)
    jax_model, _ = jax_train_variables(SIZE, SIZE, 2, 9)
    img = np.random.default_rng(0).normal(size=(2, SIZE, SIZE, 3)).astype(np.float32)
    np.savez(str(root / "init.npz"), **calibrated_variables(jax_model, img))
    return root, object_names()


def _flags(root, objects, tag, epochs=1):
    return [
        "-c", os.path.join(ROOT, "configs", "config_8.ini"), "--objects_to_copy_list", "",
        "--data", str(root / "data"), "--datatest", str(root / "test"), "--datameshes", str(root / "models"),
        "--object", ",".join(objects), "--imagesize", str(SIZE), str(SIZE), "--batchsize", "2", "--epochs", str(epochs),
        "--pretrained", "0", "--noise", "0", "--use_imgaug", "1", "--lr", "1e-5",
        "--load_h5_weights", "1", "--load_h5_filename", str(root / "init"), "--saveinterval", "10",
        "--validationinterval", "1", "--loginterval", "1", "--workers", "2", "--prefetch", "2", "--manualseed", "3",
        "--min_object_size_test", "1", "--outf", str(root / f"out_{tag}"),
    ]


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


@pytest.fixture(scope="module")
def runs(scene):
    from casapose_tpu.train import run_training
    from casapose_tpu.utils.config import parse_config

    root, objects = scene
    run_training(parse_config(_flags(root, objects, "jax")))
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")  # one thread, as tests/torch_parity.py explains
    cmd = [sys.executable, "-m", "casapose_tpu_torch.train", *_flags(root, objects, "port"), "--device", "cpu"]
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return root, objects, proc.stdout


def test_csvs_match_the_jax_trainer(runs):
    root, _, stdout = runs
    assert "loaded 148 arrays" in stdout and "== TRAINING == Finished epoch 1" in stdout
    for name, loss_cols in (("loss_train.csv", slice(2, 7)), ("loss_test.csv", slice(2, 7)),
                            ("train_summary.csv", slice(2, 7)), ("test_summary.csv", slice(2, 7))):
        ref, got = _rows(root / "out_jax" / name), _rows(root / "out_port" / name)
        assert got[0] == ref[0], name
        assert len(got) == len(ref) >= 2, name
        for r, g in zip(ref[1:], got[1:]):
            assert len(g) == len(r), name
            assert [c.strip() for c in g[: loss_cols.start]] == [c.strip() for c in r[: loss_cols.start]], name
            ref_loss, got_loss = np.array(r[loss_cols], float), np.array(g[loss_cols], float)
            np.testing.assert_allclose(got_loss[:4], ref_loss[:4], rtol=1e-3, err_msg=name)
            np.testing.assert_allclose(got_loss[4], ref_loss[4], rtol=1e-2, err_msg=name)
            assert g[loss_cols.stop :] == r[loss_cols.stop :], name  # loss weights; learning rate; 2D / 3D
    assert os.path.isfile(root / "out_port" / "training_checkpoints" / "step_1" / "state.pt")
