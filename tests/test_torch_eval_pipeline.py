"""The port's pipelined evaluation loop against its serial loop, on the CPU.

``run_evaluation`` with ``CASAPOSE_EVAL_PIPELINE=1`` (the default) and
``=0`` on one ``tools/synthetic_scene.py`` scene (2 objects, 5 images of
240x320, evaluated at 64x80, batch 2: two full batches and a tail), random
weights from the same seed, pose files and visual dumps on. Batches are
summed in the same order, so the loss CSV, the summary, the BOP pose files
and every visual dump are equal bit for bit apart from their time columns,
and so are the returned metrics. The pipelined loop dispatches batch N's
step before batch N-1's host work; the serial loop finishes each batch first.
"""

import os

import numpy as np
import pytest

from tests.torch_parity import single_torch_thread  # noqa: F401 (autouse)

H, W = 64, 80


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    from tools.synthetic_scene import make_meshes, make_scene, object_names

    root = tmp_path_factory.mktemp("pipeline")
    make_meshes(str(root / "models"))
    make_scene(str(root / "data" / "000000"), str(root / "models"), n_images=5)
    return root, object_names()


def _opt(root, objects, tag):
    from casapose_tpu_torch.utils.config import parse_config

    return parse_config([
        "--data", str(root / "data_none"), "--datatest", str(root / "data"), "--datameshes", str(root / "models"),
        "--object", ",".join(objects), "--modelname", "casapose_c_gcu5", "--estimate_confidence", "1",
        "--estimate_coords", "1", "--no_points", "9", "--imagesize_test", str(H), str(W),
        "--train_vectors_with_ground_truth", "1", "--min_object_size_test", "1", "--workers", "1",
        "--prefetch", "1", "--manualseed", "3", "--batchsize_test", "2", "--write_poses", "1",
        "--save_eval_batches", "1", "--outf", str(root / f"out_{tag}"), "--evalf", str(root / f"eval_{tag}"),
    ])


@pytest.fixture(scope="module")
def runs(scene):
    """{mode: (result dict, evalf path, [events])} for the pipelined ("1") and serial ("0") loops."""
    import casapose_tpu_torch.eval as ev
    import casapose_tpu_torch.utils.io as io

    root, objects = scene
    out = {}
    build, write = ev.build_test_step, io.write_poses
    try:
        for mode in ("1", "0"):
            events = []

            def recording_build(*args, **kwargs):
                step = build(*args, **kwargs)

                def recorded(batch):
                    events.append(("step", int(batch["img"].shape[0])))
                    return step(batch)

                return recorded

            def recording_write(gt, est, names, image_id, path_out, time_needed=None):
                events.append(("poses", str(np.asarray(image_id).reshape(-1)[0])))
                return write(gt, est, names, image_id, path_out, time_needed=time_needed)

            ev.build_test_step, io.write_poses = recording_build, recording_write
            os.environ["CASAPOSE_EVAL_PIPELINE"] = mode
            out[mode] = (ev.run_evaluation(_opt(root, objects, mode), device="cpu"), root / f"eval_{mode}", events)
    finally:
        ev.build_test_step, io.write_poses = build, write
        os.environ.pop("CASAPOSE_EVAL_PIPELINE", None)
    return out


def _files(evalf):
    return sorted(os.path.relpath(os.path.join(d, f), evalf) for d, _, fs in os.walk(evalf) for f in fs)


def _without_column(text, column, header_rows=1):
    """``text``'s CSV rows without ``column`` (a column name of the header, or an index) in the data rows."""
    lines = text.strip().splitlines()
    head = lines[:header_rows]
    idx = head[0].split(",").index(column) if isinstance(column, str) else column
    rows = [",".join(x for i, x in enumerate(r.split(",")) if i != idx) for r in lines[header_rows:]]
    return head, rows


def test_pipelined_and_serial_loops_write_the_same_files(runs):
    (res_p, dir_p, _), (res_s, dir_s, _) = runs["1"], runs["0"]
    files = _files(dir_p)
    assert files == _files(dir_s)
    assert "loss_test_eval.csv" in files and "test_summary_eval.csv" in files
    assert any(f.startswith("poses_out") for f in files) and any(f.startswith("visual_batch_eval_mask") for f in files)
    timed = {"loss_test_eval.csv": 6, "test_summary_eval.csv": "time", os.path.join("poses_out", "bop_evaluation.csv"): "time"}
    for f in files:
        with open(dir_p / f, "rb") as a, open(dir_s / f, "rb") as b:
            got, want = a.read(), b.read()
        if f in timed:
            got, want = (_without_column(x.decode(), timed[f]) for x in (got, want))
            assert len(got[1]) == len(want[1]) > 0, f
        assert got == want, f
    for key in ("loss", "err_2d", "err_3d", "precision"):
        np.testing.assert_array_equal(res_p[key], res_s[key])
    assert res_p["total_images"] == res_s["total_images"] == 5


def test_pipelined_loop_dispatches_before_the_host_work_of_the_batch_before(runs):
    def order(events):
        return [kind for kind, _ in events]

    steps_then_poses = ["step"] + ["poses"] * 2
    # serial: each batch's step, then its 2 (tail: 1) images' pose files
    assert order(runs["0"][2]) == steps_then_poses + steps_then_poses + ["step", "poses"]
    # pipelined: batch N's step before batch N-1's pose files
    assert order(runs["1"][2]) == ["step", "step", "poses", "poses", "step", "poses", "poses", "poses"]
    assert [x for x in runs["1"][2] if x[0] == "poses"] == [x for x in runs["0"][2] if x[0] == "poses"]
    for mode in ("0", "1"):
        res = runs[mode][0]
        assert set(res["phase_seconds"]) == {"fetch", "h2d", "dispatch", "step", "host_io"}
        assert res["steady_img_per_sec"] > 0
