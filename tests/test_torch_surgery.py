"""The weight surgery in the port against the JAX package, bit for bit, on the CPU.

``casapose_tpu/core/checkpoint.py``'s four functions work on flax HWIO
kernels (``kernel[0, 0, :, cols]``); the port's on state_dicts, whose OIHW
weights hold the same numbers as rows (``weight[cols, :, 0, 0]``). Both
packages get the same weights (JAX init, carried across with
``from_jax_variables``): a 3-object ``casapose_c_gcu5`` and a 2-object
backup, with a mapping that copies one backup object to two new ones.
After each function the port's state_dict, taken back to flax names with
``to_jax_variables``, equals the JAX result exactly.

Then the trainer's surgery path (``run_training`` with
``--copy_weights_from_backup_network`` and with
``--copy_weights_add_confidence_maps``, ``--epochs 0`` so that the
checkpoint holds the weights as the surgery left them) on a tiny written
scene, against the JAX functions applied to the trainer's initial weights;
and its FileNotFoundError without a backup file.
"""

import os

import numpy as np
import pytest
import torch

from tests.torch_parity import single_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 3
MAPPING = np.array([[0, 0], [1, 1], [1, 2], [2, 3]], np.int32)  # background, then backup object 1 to new 1 and 2


def _jax_vars(seg_dim, ver_dim, seed):
    import jax
    import jax.numpy as jnp

    from casapose_tpu.core.checkpoint import flatten_params
    from casapose_tpu.models.registry import get_model

    jm = get_model("casapose_c_gcu5", ver_dim=ver_dim, seg_dim=seg_dim)
    return flatten_params(jax.jit(lambda x: jm.init(jax.random.PRNGKey(seed), x, train=False))(
        jnp.zeros((1, 32, 32, 3), jnp.float32)))


@pytest.fixture(scope="module")
def weights():
    """(new, backup, backup without confidence maps): flat flax variables."""
    return _jax_vars(4, 3 * K, 0), _jax_vars(3, 3 * K, 1), _jax_vars(4, 2 * K, 2)


def _state(flat):
    from casapose_tpu_torch.core.convert import from_jax_variables

    return from_jax_variables(flat)


def _params(flat):
    from casapose_tpu.core.checkpoint import unflatten_params

    return unflatten_params({k.split("/", 1)[1]: v for k, v in flat.items() if k.startswith("params/")})


def _assert_equal(state, jax_params):
    from casapose_tpu.core.checkpoint import flatten_params
    from casapose_tpu_torch.core.convert import to_jax_variables

    got = to_jax_variables(state)
    want = flatten_params(jax_params)
    for k, v in want.items():
        np.testing.assert_array_equal(got[f"params/{k}"], v, err_msg=k)


def test_copy_weights_segmentation(weights):
    from casapose_tpu.core import checkpoint as jc
    from casapose_tpu_torch.core.checkpoint import copy_weights_segmentation

    new, backup, _ = weights
    out, cols = MAPPING[:, 1].tolist(), MAPPING[:, 0].tolist()
    got = copy_weights_segmentation(_state(new), _state(backup), out, cols)
    want = jc.copy_weights_segmentation(_params(new), _params(backup), out, cols)
    _assert_equal(got, want)
    w = got["pv_final_conv_segmentation.weight"]
    assert torch.equal(w[2], w[1]) and not torch.equal(w[2], _state(new)["pv_final_conv_segmentation.weight"][2])


@pytest.mark.parametrize("n", range(6, 11))
def test_copy_clade_weights(weights, n):
    from casapose_tpu.core import checkpoint as jc
    from casapose_tpu_torch.core.checkpoint import copy_clade_weights

    new, backup, _ = weights
    out, cols = MAPPING[:, 1].tolist(), MAPPING[:, 0].tolist()
    layer = f"pv_block_{n}_clade"
    backup = dict(backup)
    for w in ("gamma", "beta"):  # init tables are ones / zeros: make the copied rows tell
        backup[f"params/{layer}/{w}"] = np.random.default_rng(n).normal(size=backup[f"params/{layer}/{w}"].shape)
        backup[f"params/{layer}/{w}"] = backup[f"params/{layer}/{w}"].astype(np.float32)
    got = copy_clade_weights(_state(new), _state(backup), out, cols, layer)
    _assert_equal(got, jc.copy_clade_weights(_params(new), _params(backup), out, cols, layer))


def test_copy_weights_vertex(weights):
    from casapose_tpu.core import checkpoint as jc
    from casapose_tpu_torch.core.checkpoint import copy_weights_vertex

    new, _, no_conf = weights
    got = copy_weights_vertex(_state(new), _state(no_conf), 2 * K)
    _assert_equal(got, jc.copy_weights_vertex(_params(new), _params(no_conf), 2 * K))


def test_apply_expansion_surgery(weights):
    from casapose_tpu.core import checkpoint as jc
    from casapose_tpu_torch.core.checkpoint import apply_expansion_surgery

    new, backup, _ = weights
    got = apply_expansion_surgery(_state(new), _state(backup), MAPPING)
    _assert_equal(got, jc.apply_expansion_surgery(_params(new), _params(backup), MAPPING))


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    from tools.synthetic_scene import make_meshes, make_scene, object_names

    root = tmp_path_factory.mktemp("surgery")
    make_meshes(str(root / "models"))
    make_scene(str(root / "data" / "000000"), str(root / "models"), n_images=2)
    return root, object_names()


def _flags(root, objects, outf, *extra):
    return ["-c", os.path.join(ROOT, "configs", "config_8.ini"), "--data", str(root / "data"), "--datatest", "",
            "--datameshes", str(root / "models"), "--object", ",".join(objects), "--imagesize", "32", "32",
            "--batchsize", "2", "--train_validation_split", "1.0", "--epochs", "0", "--workers", "1",
            "--pretrained", "0", "--manualseed", "3", "--load_h5_filename", "backup", "--no_points", str(K),
            "--outf", str(outf), *extra]


def _trainer_surgery(tmp_path, scene, backup_seg_dim, backup_ver_dim, extra):
    """(the trainer's weights after the surgery, its initial weights, the backup's weights) as state_dicts."""
    import contextlib
    import io

    from casapose_tpu_torch.core.checkpoint import save_weights_npz
    from casapose_tpu_torch.models.registry import build_model_from_opt, get_model
    from casapose_tpu_torch.train import run_training
    from casapose_tpu_torch.utils.config import parse_config

    root, objects = scene
    (tmp_path / "frozen_model").mkdir()
    backup = get_model("casapose_c_gcu5", ver_dim=backup_ver_dim, seg_dim=backup_seg_dim, device="cpu",
                       generator=torch.Generator().manual_seed(9))
    with torch.no_grad():
        for name in ("pv_block_6_clade.gamma", "pv_block_6_clade.beta"):
            backup.state_dict()[name].normal_(generator=torch.Generator().manual_seed(4))
    save_weights_npz(str(tmp_path / "frozen_model" / "backup.npz"), backup)
    opt = parse_config(_flags(root, objects, tmp_path, *extra))
    with contextlib.redirect_stdout(io.StringIO()) as out:
        run_training(opt, device="cpu")
    assert "loaded backup network" in out.getvalue()
    init = build_model_from_opt(opt, len(objects), device="cpu", generator=torch.Generator().manual_seed(3))
    after = torch.load(tmp_path / "training_checkpoints" / "step_0" / "state.pt", weights_only=True)["model"]
    return after, init.state_dict(), backup.state_dict()


def test_trainer_expansion_surgery(tmp_path, scene):
    """Backup with 1 object, ``objects_to_copy.csv``-style mapping 1 -> 1 and 1 -> 2 (the second object starts as a
    copy of the first)."""
    from casapose_tpu.core import checkpoint as jc
    from casapose_tpu_torch.core.convert import to_jax_variables

    csv = tmp_path / "copy.csv"
    csv.write_text("1,1\n1,2\n")
    after, init, backup = _trainer_surgery(tmp_path, scene, 2, 3 * K, ["--copy_weights_from_backup_network", "1",
                                                                      "--objects_to_copy_list", str(csv),
                                                                      "--objects_in_input_network", "1"])
    mapping = np.array([[0, 0], [1, 1], [1, 2]], np.int32)
    want = jc.apply_expansion_surgery(_params(to_jax_variables(init)), _params(to_jax_variables(backup)), mapping)
    _assert_equal(after, want)
    assert torch.equal(after["pv_final_conv_segmentation.weight"][2], backup["pv_final_conv_segmentation.weight"][1])


def test_trainer_add_confidence_maps(tmp_path, scene):
    from casapose_tpu.core import checkpoint as jc
    from casapose_tpu_torch.core.convert import to_jax_variables

    after, init, backup = _trainer_surgery(tmp_path, scene, 3, 2 * K, ["--copy_weights_add_confidence_maps", "1",
                                                                      "--objects_to_copy_list", ""])
    want = jc.copy_weights_vertex(_params(to_jax_variables(init)), _params(to_jax_variables(backup)), 2 * K)
    _assert_equal(after, want)


def test_trainer_surgery_without_a_backup_file(tmp_path, scene):
    from casapose_tpu_torch.train import run_training
    from casapose_tpu_torch.utils.config import parse_config

    root, objects = scene
    opt = parse_config(_flags(root, objects, tmp_path, "--copy_weights_from_backup_network", "1",
                              "--objects_to_copy_list", ""))
    with pytest.raises(FileNotFoundError, match="backup"):
        run_training(opt, device="cpu")
