"""``--remat`` in the port: the network forward under ``torch.utils.checkpoint`` must not change the step.

As tests/test_remat.py holds ``jax.checkpoint`` for the JAX step: one step
of ``build_train_step`` from the same weights on
``__graft_entry__.py::build_synthetic_train_case(b=4, h=32, w=32,
noise=0.0)``'s batch, with ``cfg.remat`` off and on. The losses and every
parameter agree at JAX's rtol 1e-5, atol 1e-6, and the BatchNorm running
statistics are *equal* to the non-remat run's: the recomputed forward in
the backward pass must not update them a second time. Without the
recompute context (``models/layers.py::remat_context_fn``) they would, and
the last test shows that the check sees it. The remat step is also held
against the JAX remat step (first losses, rtol 1e-4, as
tests/test_torch_train_step.py).
"""

import contextlib
import dataclasses

import numpy as np
import pytest

from tests.torch_parity import single_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def case():
    from __graft_entry__ import build_synthetic_train_case
    from casapose_tpu.core.checkpoint import flatten_params
    from casapose_tpu_torch.losses.losses import LossWeights
    from casapose_tpu_torch.train import StepConfig

    jm, variables, jcfg, jlw, batch = build_synthetic_train_case(b=4, h=32, w=32, noise=0.0)
    batch = {k: v.astype(np.float32) if v.dtype == np.float64 else v for k, v in batch.items()}
    cfg, lw = StepConfig(**dataclasses.asdict(jcfg)), LossWeights(**dataclasses.asdict(jlw))
    return jm, variables, flatten_params(variables), jcfg, jlw, cfg, lw, batch


def _one_step(case, remat):
    from casapose_tpu_torch.core.optimizer import AdamTF
    from casapose_tpu_torch.train import build_train_step, device_batch
    from tests.torch_parity import port_train_model

    _, _, flat, _, _, cfg, lw, batch = case
    model = port_train_model(flat, cfg.no_objects, cfg.no_points)
    step = build_train_step(model, AdamTF(model.parameters(), 1e-3), dataclasses.replace(cfg, remat=remat), lw)
    losses = step(device_batch(batch, "cpu")).numpy()
    return losses, {n: v.detach().clone().numpy() for n, v in model.state_dict().items()}


def test_remat_step_equals_the_plain_step(case):
    losses_a, state_a = _one_step(case, remat=False)
    losses_b, state_b = _one_step(case, remat=True)
    np.testing.assert_allclose(losses_b, losses_a, rtol=1e-5, atol=1e-6)
    stats = [n for n in state_a if n.endswith(("running_mean", "running_var"))]
    assert len(stats) > 40
    for name, a in state_a.items():
        if name in stats:
            np.testing.assert_array_equal(state_b[name], a, err_msg=f"running statistic updated twice? {name}")
        else:
            np.testing.assert_allclose(state_b[name], a, rtol=1e-5, atol=1e-6, err_msg=f"param diverges: {name}")


def test_remat_step_against_jax(case):
    import jax
    import jax.numpy as jnp

    from casapose_tpu.core.optimizer import adam_tf
    from casapose_tpu.train import TrainState
    from casapose_tpu.train import build_train_step as jax_build_train_step

    jm, variables, _, jcfg, jlw, _, _, batch = case
    tx = adam_tf(1e-3)
    state = TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]), step=jnp.zeros([], jnp.int32))
    _, lj = jax_build_train_step(jm, tx, dataclasses.replace(jcfg, remat=True), jlw)(
        state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    np.testing.assert_allclose(_one_step(case, remat=True)[0], np.asarray(lj), rtol=1e-4)


def test_without_the_recompute_context_the_statistics_update_twice(case):
    """The check above would see a double update: with a recompute context that leaves BatchNorm's running update
    on, the running statistics move again in the backward pass and differ from the plain step's."""
    import casapose_tpu_torch.train as train

    _, state_a = _one_step(case, remat=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train, "remat_context_fn", lambda: (contextlib.nullcontext(), contextlib.nullcontext()))
        _, state_b = _one_step(case, remat=True)
    differ = [n for n in state_a if n.endswith("running_mean") and not np.array_equal(state_a[n], state_b[n])]
    assert len(differ) > 20
