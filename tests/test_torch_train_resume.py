"""The port's trainer resumes from its own checkpoint, and its eval harness reads it, on the CPU.

``run_training(opt, device="cpu")`` (the driver of ``python -m
casapose_tpu_torch.train``, run in this process) trains one epoch on a
``tools/synthetic_scene.py`` scene (casapose_c_gcu5 from random weights,
32x32, batch 2, the record cache on as the trainer's default), then runs
again with ``--epochs 2``: it restores ``step_1`` (model, optimizer and step
count), trains epoch 2 only and writes ``step_2``. The eval harness
(``run_evaluation``) then restores ``step_2`` as its weights, where it
refuses an orbax checkpoint of the JAX package and names the export routes.
"""

import contextlib
import io
import os

import numpy as np
import pytest

from tests.torch_parity import single_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(run, flags):
    """(the driver's result, what it printed) for ``run(parse_config(flags), device="cpu")``."""
    from casapose_tpu_torch.utils.config import parse_config

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = run(parse_config(flags), device="cpu")
    return result, out.getvalue()


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    from tools.synthetic_scene import make_meshes, make_scene, object_names

    root = tmp_path_factory.mktemp("train_resume")
    make_meshes(str(root / "models"))
    make_scene(str(root / "data" / "000000"), str(root / "models"), n_images=4)
    flags = ["-c", os.path.join(ROOT, "configs", "config_8.ini"), "--objects_to_copy_list", "",
             "--data", str(root / "data"), "--datatest", "", "--datameshes", str(root / "models"),
             "--object", ",".join(object_names()), "--imagesize", "32", "32", "--batchsize", "2",
             "--train_validation_split", "1.0", "--saveinterval", "10", "--loginterval", "1",
             "--workers", "2", "--prefetch", "2", "--manualseed", "3", "--outf", str(root / "out")]
    from casapose_tpu_torch.train import run_training

    with pytest.MonkeyPatch.context() as mp:  # config_8 asks for the ImageNet backbone: no file anywhere here
        mp.delenv("CASAPOSE_IMAGENET_H5", raising=False)
        mp.setenv("HOME", str(root / "home"))
        state1, first = _run(run_training, [*flags, "--epochs", "1"])
        state2, second = _run(run_training, [*flags, "--epochs", "2"])
    assert (state1.step, state2.step) == (2, 4)
    from casapose_tpu_torch.core.checkpoint import save_weights_npz

    save_weights_npz(str(root / "backup.npz"), state2.model)
    return root, object_names(), first, second


def test_resume_trains_only_the_next_epoch(trained):
    root, _, first, second = trained
    assert "Finished epoch 1 " in first and "restored checkpoint" not in first
    assert "restored checkpoint at epoch 1" in second
    assert "Finished epoch 2" in second and "Finished epoch 1 " not in second
    assert "imagenet weights unavailable for resnet18" in first  # the JAX trainer's offline lines
    assert "pretrained=1 but imagenet weights unavailable; training from random init" in first
    with open(root / "out" / "train_summary.csv") as f:
        rows = [r.split(",") for r in f.read().strip().splitlines()]
    assert [r[0] for r in rows[1:]] == ["2"] and np.isfinite(float(rows[1][2]))
    ckpt = root / "out" / "training_checkpoints"
    assert sorted(os.listdir(ckpt)) == ["step_1", "step_2"]
    assert len(list((root / "out" / "record_cache" / "train").glob("*.npy"))) == 4


def test_eval_harness_reads_the_ports_checkpoint_and_refuses_orbax(trained):
    root, objects, _, _ = trained
    flags = ["--datatest", str(root / "data"), "--data", str(root / "none"), "--datameshes", str(root / "models"),
             "--object", ",".join(objects), "--modelname", "casapose_c_gcu5", "--estimate_confidence", "1",
             "--estimate_coords", "1", "--imagesize_test", "32", "32", "--batchsize_test", "2",
             "--outf", str(root / "out"), "--net", "training_checkpoints", "--evalf", str(root / "eval"),
             "--min_object_size_test", "1"]
    from casapose_tpu_torch.eval import run_evaluation

    result, printed = _run(run_evaluation, flags)
    assert "restored checkpoint" in printed and "step_2" in printed and "== TEST == Finished" in printed
    assert np.isfinite(result["loss"]).all()
    (root / "out" / "training_checkpoints" / "step_3").mkdir()  # a step without the port's state: orbax's layout
    with pytest.raises(NotImplementedError, match="orbax.*save_weights_npz"):
        _run(run_evaluation, flags)


@pytest.mark.parametrize("flag", [("--remat", "1"), ("--profile_dir", "prof"), ("--save_debug_batch", "1"),
                                  ("--copy_weights_from_backup_network", "1")])
def test_unported_options_raise(trained, flag, tmp_path):
    """The options that the trainer refused before (naming its ROADMAP queue) now run on the scene:
    ``--remat`` and ``--profile_dir`` train an epoch (the trace written), ``--save_debug_batch`` writes the first
    batch and stops, and the weight surgery reads its backup network (here the ``.npz`` of the resumed run, of the
    same objects)."""
    import shutil

    from casapose_tpu_torch.train import run_training

    root, objects, _, _ = trained
    out = tmp_path / "out"
    flags = ["-c", os.path.join(ROOT, "configs", "config_8.ini"), "--objects_to_copy_list", "",
             "--data", str(root / "data"), "--datatest", "", "--datameshes", str(root / "models"),
             "--object", ",".join(objects), "--imagesize", "32", "32", "--batchsize", "2", "--epochs", "1",
             "--train_validation_split", "1.0", "--workers", "1", "--pretrained", "0", "--outf", str(out), *flag]
    if flag[0] == "--profile_dir":
        flags[-1] = str(tmp_path / "prof")
    if flag[0] == "--copy_weights_from_backup_network":
        (out / "frozen_model").mkdir(parents=True)
        shutil.copy(root / "backup.npz", out / "frozen_model" / "backup.npz")
        flags += ["--load_h5_filename", "backup", "--objects_in_input_network", str(len(objects))]
    state, printed = _run(run_training, flags)
    if flag[0] == "--save_debug_batch":
        assert state is None and "saved debug batch; exiting" in printed
        assert sorted(os.listdir(out / "visual_batch")) == ["0000_img.png", "0000_mask.png", "0001_img.png",
                                                           "0001_mask.png"]
        return
    assert state.step == 2 and "Finished epoch 1" in printed
    if flag[0] == "--profile_dir":
        assert (tmp_path / "prof" / "train_trace.json").is_file()
    if flag[0] == "--copy_weights_from_backup_network":
        assert "loaded backup network (148 arrays)" in printed
