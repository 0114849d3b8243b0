"""``python -m casapose_tpu_torch.eval`` against the JAX harness for the configurations beyond the flagship's.

As tests/test_torch_harness.py, on its synthetic scene (2 objects, 5 images
evaluated at 64x80, batch 2): the same weights, written as the JAX
package's ``.npz`` export, through both harnesses, for
  * ``pvnet`` down the RANSAC branch (``--estimate_coords 0
    --estimate_confidence 0 --ransac_rounds 2``), the reference's RANSAC
    configuration;
  * the flagship with ``--compute_dtype bfloat16``;
  * ``casapose_custom`` with ``--custom_decoder_params``.
Their CSVs have the same header and rows, and the 2D/3D columns are equal
as text (random weights give no valid pose, whatever the voting draws). The
losses agree to rtol 1e-4 in float32 (float32 sums in another order). In
bfloat16 the network's outputs carry bfloat16's rounding
(tests/test_torch_bf16.py): the mask, vertex and proxy losses, means over
~10^4 such values, agree to rtol 2e-3 (measured: at most 1.2e-3); the
keypoint loss, a reprojection error of poses solved from points voted on
those directions, and the total that includes it, to rtol 1e-2 (measured:
3.0e-3). The ``time`` column is not compared.
"""

import csv
import os
import subprocess
import sys

import numpy as np
import pytest

from tests.test_torch_harness import H, ROOT, W, scene  # noqa: F401  (the module-scoped scene fixture)
from tests.test_torch_variants import CUSTOM
from tests.torch_parity import calibrated_variables

CONFIGS = {
    "pvnet_ransac": (["--modelname", "pvnet", "--estimate_confidence", "0", "--estimate_coords", "0",
                      "--ransac_rounds", "2"], 1e-4),
    "bfloat16": (["--modelname", "casapose_c_gcu5", "--estimate_confidence", "1", "--estimate_coords", "1",
                  "--compute_dtype", "bfloat16"], (1e-2, 2e-3, 2e-3, 2e-3, 1e-2)),
    "custom_decoder": (["--modelname", "casapose_custom", "--estimate_confidence", "1", "--estimate_coords", "1",
                        "--custom_decoder_params", CUSTOM], 1e-4),
}  # config: (flags, rtol of [loss, mask, vertex, proxy, kp])


def _flags(root, objects, weights_path, tag, config):
    return [
        "--data", str(root / "data_none"), "--datatest", str(root / "data"), "--datameshes", str(root / "models"),
        "--object", ",".join(objects), "--no_points", "9", "--imagesize_test", str(H), str(W),
        "--train_vectors_with_ground_truth", "1", "--min_object_size_test", "1", "--workers", "1",
        "--prefetch", "1", "--manualseed", "3", "--batchsize_test", "2",
        "--load_h5_weights", "1", "--load_h5_filename", weights_path, "--keypoint_loss_weight", "0.007",
        "--proxy_loss_weight", "0.015", "--outf", str(root / f"out_{tag}"), "--evalf", str(root / f"eval_{tag}"),
        *CONFIGS[config][0],
    ]


@pytest.fixture(scope="module", params=list(CONFIGS))
def runs(scene, request):  # noqa: F811
    from casapose_tpu.eval import run_evaluation
    from casapose_tpu.train import build_model_from_opt
    from casapose_tpu.utils.config import parse_config

    root, objects = scene
    config = request.param
    weights = str(root / f"w_{config}")
    jm = build_model_from_opt(parse_config(_flags(root, objects, weights, "x", config)), len(objects))
    flat = calibrated_variables(jm, np.random.default_rng(0).normal(size=(2, H, W, 3)).astype(np.float32))
    np.savez(weights + ".npz", **flat)
    run_evaluation(parse_config(_flags(root, objects, weights, f"jax_{config}", config)))
    proc = subprocess.run(
        [sys.executable, "-m", "casapose_tpu_torch.eval", *_flags(root, objects, weights, f"port_{config}", config),
         "--device", "cpu"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert f"loaded {len(flat)} arrays" in proc.stdout and "== TEST == Finished" in proc.stdout
    return config, root / f"eval_jax_{config}", root / f"eval_port_{config}"


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


@pytest.mark.parametrize("name, time_col", [("loss_test_eval.csv", 6), ("test_summary_eval.csv", 5)])
def test_csvs_match_jax(runs, name, time_col):
    config, jax_dir, port_dir = runs
    want, got = _rows(os.path.join(jax_dir, name)), _rows(os.path.join(port_dir, name))
    assert got[0] == want[0]
    assert len(got) == len(want) == (4 if name.startswith("loss") else 2)
    first_loss = 1 if name.startswith("loss") else 0
    for g, w in zip(got[1:], want[1:]):
        assert len(g) == len(w) and g[:first_loss] == w[:first_loss]
        rtol = np.broadcast_to(CONFIGS[config][1], (5,))
        got_losses, want_losses = (np.array([float(x) for x in r[first_loss:time_col]]) for r in (g, w))
        assert (np.abs(got_losses - want_losses) <= rtol * np.abs(want_losses)).all(), (got_losses, want_losses)
        assert g[time_col + 1 :] == w[time_col + 1 :]
