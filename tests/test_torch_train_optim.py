"""The optimizer, schedules, weight bridge and checkpoints of the port's trainer against the JAX package's, on the CPU.

* ``AdamTF`` against ``adam_tf`` over 5 steps of seeded gradients (some
  exactly zero, magnitudes 1e-8 to 1) under a piecewise schedule: rtol 1e-6
  (measured: equal).
* ``make_lr_schedule`` at every step across every boundary: the piecewise
  schedule exactly; the late-start exponential decay with the same exponent
  at every step and its value within one float32 ulp (two libraries' pow).
* ``LossWeightHandler`` updates and clamps as the JAX one does.
* ``to_jax_variables`` inverts ``from_jax_variables`` both ways, and
  ``save_weights_npz`` writes a file the JAX package's ``load_weights_npz``
  takes whole.
* ``save_checkpoint`` / ``restore_checkpoint``: the newest 5 kept; a restored
  model and optimizer continue bit for bit.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax

from tests.torch_parity import jax_train_variables
from tests.torch_parity import single_torch_thread  # noqa: F401 (autouse)


def test_adam_tf_matches_the_jax_transform():
    from casapose_tpu.core.optimizer import adam_tf
    from casapose_tpu.losses.schedules import make_lr_schedule as jax_schedule
    from casapose_tpu_torch.core.optimizer import AdamTF
    from casapose_tpu_torch.losses.schedules import make_lr_schedule

    rng = np.random.default_rng(0)
    shapes = [(3, 4), (5,), (2, 2, 3, 3)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[(rng.normal(size=s) * 10.0 ** rng.integers(-8, 1)).astype(np.float32) for s in shapes] for _ in range(5)]
    for g in grads:
        g[1][:2] = 0.0
    args = (0.01, 0.5, 15, 0, [1, 2], 2)  # boundaries at steps 1 and 3
    tx = adam_tf(jax_schedule(*args))
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = AdamTF(tp, make_lr_schedule(*args))
    for step, g in enumerate(grads):
        missing = step == 2  # no gradient at all in the port: a zero gradient, as JAX updates every leaf
        updates, state = tx.update([jnp.zeros_like(x) if missing else jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, x in zip(tp, g):
            p.grad = None if missing else torch.from_numpy(x)
        opt.step()
    for a, b in zip(jp, tp):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), rtol=1e-6, atol=0)
    assert opt.param_groups[0]["count"] == 5 == int(state.count)


def test_schedules_at_every_step():
    from casapose_tpu.losses.schedules import make_lr_schedule as jax_schedule
    from casapose_tpu_torch.losses.schedules import make_lr_schedule

    for args in [(0.001, 0.5, 15, 0, [50, 75, 90], 7), (0.001, 0.5, 15, 0, [1, 2, 3], 4)]:
        js, ps = jax_schedule(*args), make_lr_schedule(*args)
        for step in range(0, 100 * args[-1]):
            assert ps(step) == np.float32(js(jnp.int32(step))), (args, step)
    for args in [(0.001, 0.95, 3, 0, None, 7), (0.003, 0.9, 2, 4, None, 5), (1e-4, 0.7, 1, 1, None, 3)]:
        js, ps = jax_schedule(*args), make_lr_schedule(*args)
        rate = np.float32(args[1])
        for step in range(0, 60 * args[-1]):
            ref, got = np.float32(js(jnp.int32(step))), ps(step)
            assert isinstance(got, np.float32)
            # The same exponent: the value divided by lr0 is rate ** p for one integer p.
            p = np.round(np.log(np.float64(ref) / np.float32(args[0])) / np.log(np.float64(rate)))
            assert np.abs(got - ref) <= np.spacing(ref), (args, step, ref, got)
            assert np.round(np.log(np.float64(got) / np.float32(args[0])) / np.log(np.float64(rate))) == p


def test_loss_weight_handler():
    from casapose_tpu.losses.schedules import LossWeightHandler as JaxHandler
    from casapose_tpu_torch.losses.schedules import LossWeightHandler

    kw = dict(mask_loss_weight=1.0, vertex_loss_weight=0.5, proxy_loss_weight=0.015, kp_loss_weight=0.007,
              filter_vertex_with_segmentation=True, update_rate=3.0, max_weight=0.9)
    j, p = JaxHandler(**kw), LossWeightHandler(**kw)
    for _ in range(3):
        j.update()
        p.update()
        assert vars(j) == vars(p)
    lw_j, lw_p = j.as_loss_weights(), p.as_loss_weights()
    assert {f: getattr(lw_j, f) for f in vars(lw_j)} == {f: getattr(lw_p, f) for f in vars(lw_j)}


@pytest.fixture(scope="module")
def flat_variables():
    from casapose_tpu.core.checkpoint import flatten_params

    _, variables = jax_train_variables(32, 32, 2, 3)
    return flatten_params(variables)


def test_weight_bridge_round_trip(flat_variables, tmp_path):
    from casapose_tpu.core.checkpoint import load_weights_npz as jax_load_npz
    from casapose_tpu_torch.core.checkpoint import save_weights_npz
    from casapose_tpu_torch.core.convert import from_jax_variables, to_jax_variables
    from tests.torch_parity import port_train_model

    back = to_jax_variables(from_jax_variables(flat_variables))
    assert set(back) == set(flat_variables)
    for key, v in flat_variables.items():
        np.testing.assert_array_equal(back[key], v, err_msg=key)
    model = port_train_model(flat_variables, 2, 3)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.25)
    sd = model.state_dict()
    again = from_jax_variables(to_jax_variables(sd), model)
    for name, v in sd.items():
        torch.testing.assert_close(again[name], v, rtol=0, atol=0)
    save_weights_npz(str(tmp_path / "w.npz"), model)
    _, variables = jax_train_variables(32, 32, 2, 3)
    merged, loaded, skipped = jax_load_npz(str(tmp_path / "w.npz"), dict(variables))
    assert loaded == len(flat_variables) and not skipped
    kernel = merged["params"]["pv_final_conv_vertex"]["kernel"]
    np.testing.assert_array_equal(np.asarray(kernel), flat_variables["params/pv_final_conv_vertex/kernel"] + 0.25)


def test_checkpoints_keep_five_and_resume_bit_for_bit(flat_variables, tmp_path):
    from casapose_tpu_torch.core.checkpoint import latest_checkpoint_step, restore_checkpoint, save_checkpoint
    from casapose_tpu_torch.core.optimizer import AdamTF
    from casapose_tpu_torch.losses.schedules import make_lr_schedule
    from tests.torch_parity import port_train_model

    def fresh():
        model = port_train_model(flat_variables, 2, 3)
        return model, AdamTF(model.parameters(), make_lr_schedule(1e-3, 0.5, 15, 0, [1], 3))

    def step(model, opt, seed):
        gen = torch.Generator().manual_seed(seed)
        for p in model.parameters():
            p.grad = torch.randn(p.shape, generator=gen)
        opt.step()

    model, opt = fresh()
    path = str(tmp_path / "ckpt")
    assert restore_checkpoint(path, model, opt) is None and latest_checkpoint_step(path) is None
    for s in range(1, 8):
        step(model, opt, s)
        save_checkpoint(path, model, opt, s)
    assert sorted(int(d.split("_")[1]) for d in os.listdir(path)) == [3, 4, 5, 6, 7]
    step(model, opt, 100)
    model2, opt2 = fresh()
    assert restore_checkpoint(path, model2, opt2) == 7
    assert opt2.param_groups[0]["count"] == 7
    step(model2, opt2, 100)
    for (n, a), b in zip(model.state_dict().items(), model2.state_dict().values()):
        torch.testing.assert_close(b, a, rtol=0, atol=0, msg=n)
    (tmp_path / "ckpt" / "step_9").mkdir()  # a step without the port's state file: an orbax checkpoint
    with pytest.raises(ValueError, match="orbax"):
        restore_checkpoint(path, model2, opt2)


@pytest.mark.parametrize("config", ["config_8.ini", "config_13.ini"])
def test_training_flags_parse_as_in_jax(config):
    """Every flag the trainer reads parses to the JAX package's value, from both shipped configs and CLI overrides."""
    from casapose_tpu.utils.config import parse_config as jax_parse
    from casapose_tpu_torch.utils.config import parse_config

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    argv = ["-c", os.path.join(root, "configs", config), "--objects_to_copy_list", "", "--lr_epochs_steps", "3,5",
            "--pretrained", "false", "--use_bpnp_reprojection_loss", "1", "--cache_records", "0", "--imagesize", "64",
            "96", "--compute_dtype", "bfloat16", "--manualseed", "5", "--data", "/d/train", "--datatest", "/d/test"]
    want, got = vars(jax_parse(argv)), vars(parse_config(argv))
    assert set(got) == set(want)
    for key in want:
        if isinstance(want[key], np.ndarray):
            np.testing.assert_array_equal(got[key], want[key])
        else:
            assert got[key] == want[key], key
