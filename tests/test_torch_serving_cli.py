"""The serving CLIs of the port on the CPU: ``python -m casapose_tpu_torch.test_minimal`` and ``export_model``.

One ``tools/synthetic_scene.py`` scene (2 objects, 3 images of 240x320).
``ImageOnlyDataset`` (copied from the JAX package) must give the JAX
package's file list and batches exactly. ``test_minimal`` must write the JAX
script's ``speed_eval.csv`` (header, one row per image, the mean row, the same
"batches 10+" rule), also with ``--quantized_inference int8``;
``export_model`` must write one program per device of
``--export_platforms`` whose poses equal the live serving function's on the
same weights (rtol / atol 1e-6, the JAX export test's band).
"""

import os

import numpy as np
import pytest
from tests.torch_parity import single_torch_thread  # noqa: F401 (autouse: one torch thread)

N_IMAGES = 3


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    from tools.synthetic_scene import make_meshes, make_scene, object_names

    root = tmp_path_factory.mktemp("serving")
    make_meshes(str(root / "models"))
    make_scene(str(root / "data" / "000000"), str(root / "models"), n_images=N_IMAGES)
    return root, object_names()


def _flags(root, objects, *extra):
    return ["--datatest", str(root / "data"), "--data", str(root / "none"), "--datameshes", str(root / "models"),
            "--object", ",".join(objects), "--modelname", "casapose_c_gcu5", "--estimate_confidence", "1",
            "--estimate_coords", "1", "--no_points", "9", "--imagesize_test", "64", "80", "--manualseed", "3",
            "--outf", str(root / "out"), *extra]


@pytest.mark.parametrize("batchsize", [1, 2])
def test_image_only_dataset_matches_jax(scene, batchsize):
    from casapose_tpu.data.image_only import ImageOnlyDataset as JaxImageOnlyDataset
    from casapose_tpu_torch.data.image_only import ImageOnlyDataset

    root, _ = scene
    got, want = ImageOnlyDataset(str(root / "data")), JaxImageOnlyDataset(str(root / "data"))
    assert got.imgs == want.imgs and len(got.imgs) == N_IMAGES
    assert all(p.endswith(("0.png", "1.png", "2.png")) and ".seg." not in p for p in got.imgs)
    (g, n_g), (w, n_w) = got.generate_dataset(batchsize), want.generate_dataset(batchsize)
    assert n_g == n_w == N_IMAGES // batchsize
    batches = list(zip(g, w))
    assert len(batches) == n_g
    for a, b in batches:
        assert a.dtype == np.float32 and a.shape == (batchsize, 240, 320, 3)
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("quantized", [False, True], ids=["float32", "int8"])
def test_test_minimal_writes_the_speed_csv(scene, quantized, capsys):
    from casapose_tpu_torch.test_minimal import main

    root, objects = scene
    evalf = root / ("eval_int8" if quantized else "eval")
    extra = ["--quantized_inference", "int8"] if quantized else []
    assert main(_flags(root, objects, "--evalf", str(evalf), "--device", "cpu", *extra)) == 0
    with open(evalf / "speed_eval.csv") as f:
        rows = [r.split(",") for r in f.read().strip().splitlines()]
    assert rows[0] == ["batchid", "time"]
    assert [r[0] for r in rows[1:]] == [str(i + 1) for i in range(N_IMAGES)] + ["mean"]
    times = [float(r[1]) for r in rows[1:]]
    assert all(t > 0 for t in times)
    assert times[-1] == pytest.approx(np.mean(times[1:N_IMAGES]), abs=2e-6)  # fewer than 11 batches: 1+
    assert "mean time (batches 10+)" in capsys.readouterr().out


def test_export_model_writes_loadable_programs(scene, capsys):
    import torch

    from casapose_tpu_torch.core.export import build_serving_fn, load_exported
    from casapose_tpu_torch.export_model import export_devices, main
    from casapose_tpu_torch.models.registry import build_model_from_opt
    from casapose_tpu_torch.utils.config import parse_config

    assert export_devices("tpu,cpu,gpu,cuda") == ["cuda", "cpu"]
    assert export_devices("cpu") == ["cpu"]
    root, objects = scene
    path = root / "serving" / "casapose.pt2"
    flags = _flags(root, objects, "--export_path", str(path), "--batchsize_test", "2")
    assert main(flags + ["--export_platforms", "cpu", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"wrote {path}" in out and "input (2,64,80,3) -> poses (2,2,1,3,4)" in out and "device cpu" in out

    opt = parse_config(flags)
    model = build_model_from_opt(opt, 2, device="cpu", generator=torch.Generator().manual_seed(3))
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.normal(size=(2, 64, 80, 3)).astype(np.float32))
    kp3 = torch.from_numpy(rng.uniform(-0.05, 0.05, (2, 2, 1, 9, 3)).astype(np.float32))
    cam = torch.tensor([[60.0, 0, 40], [0, 60.0, 32], [0, 0, 1]]).expand(2, 3, 3).contiguous()
    with open(path, "rb") as f:
        got = load_exported(f.read())(img, kp3, cam)
    with torch.no_grad():
        want = build_serving_fn(model, 2, 9)(img, kp3, cam)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    with pytest.raises(SystemExit):
        main(_flags(root, objects, "--export_platforms", "cpu", "--device", "cpu"))  # no --export_path
    assert not os.path.exists(root / "serving" / "casapose.cpu.pt2")
