"""Data parallelism of the port: 2 gloo ranks equal 1 process at the same global batch, on the CPU.

The JAX trainer shards the global batch over its mesh and gets the gradient
mean, the BatchNorm moments of the global batch and the global sums of the
losses from GSPMD (tests/test_dp_invariance.py holds 8 devices against 1).
The port runs a process per rank (``parallel/mesh.py``): two gloo processes
(``torch.multiprocessing``, a free port), each with its half of a global
batch of 4, against one process on the whole batch, through
``build_train_step(..., data_parallel=...)`` (``DistributedDataParallel``,
synced BatchNorm, the keypoint loss over the global count of available
objects). The batch is ``__graft_entry__.py::build_synthetic_train_case``'s
(b=4, 32x32, noise 0) with the second object removed from the second half's
masks: the halves differ in their available objects (4 and 2) and in their
foreground pixels, where averaging two per-rank keypoint losses is wrong.

Tolerances, tighter than tests/test_dp_invariance.py's where the port
reaches it: the losses of step 1 at rtol 1e-5 (JAX's test: 3e-4; measured
1.7e-7), of step 2 at rtol 1e-4 (JAX's: 5e-3; measured 4.3e-6); DDP's
averaged gradients within 3e-4 of each tensor's max of the one-process
gradients (measured 7.9e-5: float32 sums in another order); the weights
after step 1 within what the first AdamTF update makes of that gradient
agreement plus float32 rounding; the running statistics within 1e-5 of
each tensor's max; both ranks bit-identical. The one-process step is held
against the JAX step on the same batch and weights (first losses, rtol
1e-4, as tests/test_torch_train_step.py). Last, the trainer's entry point
under ``torchrun`` (2 gloo processes) against the trainer in one process
on a written scene: one set of files, the global batch's losses.
"""

import os
import socket

import numpy as np
import pytest
import torch

from tests.torch_parity import single_torch_thread  # noqa: F401 (autouse)

WORLD, B, H, W, OC, K = 2, 4, 32, 32, 2, 3
LR = 1e-3


def _case():
    """(flax model, flat JAX variables, JAX StepConfig, JAX LossWeights, batch) with unequal halves."""
    from __graft_entry__ import build_synthetic_train_case
    from casapose_tpu.core.checkpoint import flatten_params

    jm, variables, jcfg, jlw, batch = build_synthetic_train_case(no_objects=OC, k=K, b=B, h=H, w=W, noise=0.0)
    batch = {k: v.astype(np.float32) if v.dtype == np.float64 else v for k, v in batch.items()}
    seg = batch["seg"].copy()
    seg[B // 2 :][seg[B // 2 :] == 2] = 0  # the second half holds no pixel of object 2
    batch["seg"] = seg
    return jm, variables, flatten_params(variables), jcfg, jlw, batch


def _port_cfg(jcfg, jlw):
    import dataclasses

    from casapose_tpu_torch.losses.losses import LossWeights
    from casapose_tpu_torch.train import StepConfig

    return StepConfig(**dataclasses.asdict(jcfg)), LossWeights(**dataclasses.asdict(jlw))


def _run_steps(flat, cfg, lw, batch, data_parallel=None, steps=2):
    """(losses [steps, 5], state_dict after step 1) of the port's train step on ``batch`` (this rank's rows)."""
    from casapose_tpu_torch.core.optimizer import AdamTF
    from casapose_tpu_torch.train import build_train_step, device_batch
    from tests.torch_parity import port_train_model

    model = port_train_model(flat, OC, K)
    step = build_train_step(model, AdamTF(model.parameters(), LR), cfg, lw, data_parallel=data_parallel)
    tb = device_batch(batch, "cpu")
    losses, after1 = [], None
    for i in range(steps):
        losses.append(step(tb).numpy())
        if i == 0:
            after1 = {n: v.detach().clone().numpy() for n, v in model.state_dict().items()}
            after1.update({f"grad/{n}": p.grad.clone().numpy() for n, p in model.named_parameters()})
    return np.array(losses), after1


def _rank(rank, port, flat, cfg, lw, batch, out_dir):
    """One gloo rank: its rows of the global batch through the data-parallel step; results to ``out_dir``."""
    torch.set_num_threads(1)
    from casapose_tpu_torch.parallel.mesh import init_data_parallel, shutdown

    dp = init_data_parallel("cpu", rank=rank, world_size=WORLD, init_method=f"tcp://127.0.0.1:{port}")
    try:
        rows = dp.rows(B)
        losses, after1 = _run_steps(flat, cfg, lw, {k: v[rows] for k, v in batch.items()}, data_parallel=dp)
    finally:
        shutdown()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), losses=losses, **{f"state/{k}": v for k, v in after1.items()})


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _available(flat, cfg, batch):
    """Per image, the objects the keypoint loss counts (the train step's first forward)."""
    from casapose_tpu_torch.data.pipeline import prepare_device_batch
    from casapose_tpu_torch.train import device_batch
    from tests.torch_parity import port_train_model

    model = port_train_model(flat, OC, K).train()
    tb = device_batch(batch, "cpu")
    with torch.no_grad():
        img, tseg = prepare_device_batch(tb["img"], tb["seg"], OC + 1)
        out = model(img, tseg)
    est = torch.argmax(out[..., : OC + 1], dim=-1)
    px_est = torch.stack([(est == o).sum(dim=(1, 2)) for o in range(1, OC + 1)], 1)
    px_gt = tseg[..., 1:].sum(dim=(1, 2))
    return ((px_est > 50) & (px_gt > 50)).sum(1).numpy()


@pytest.fixture(scope="module")
def two_ranks_and_one(tmp_path_factory):
    import torch.multiprocessing as mp

    jm, variables, flat, jcfg, jlw, batch = _case()
    cfg, lw = _port_cfg(jcfg, jlw)
    out_dir = str(tmp_path_factory.mktemp("ddp"))
    mp.start_processes(_rank, args=(_free_port(), flat, cfg, lw, batch, out_dir), nprocs=WORLD, join=True,
                       start_method="spawn")
    ranks = [np.load(os.path.join(out_dir, f"rank{r}.npz")) for r in range(WORLD)]
    one = _run_steps(flat, cfg, lw, batch)
    return jm, variables, flat, jcfg, jlw, batch, cfg, ranks, one


def test_the_halves_differ_in_available_objects(two_ranks_and_one):
    _, _, flat, _, _, batch, cfg, _, _ = two_ranks_and_one
    avail = _available(flat, cfg, batch)
    first, second = avail[: B // 2].sum(), avail[B // 2 :].sum()
    assert first != second and second > 0, avail
    fg = (batch["seg"][..., 0] > 0).reshape(B, -1).sum(1)
    assert fg[: B // 2].sum() != fg[B // 2 :].sum()


def test_two_gloo_ranks_equal_one_process(two_ranks_and_one):
    *_, ranks, (losses1, after1) = two_ranks_and_one
    for r in ranks:  # every rank logs the global batch's losses
        np.testing.assert_allclose(r["losses"][0], losses1[0], rtol=1e-5)
        np.testing.assert_allclose(r["losses"][1], losses1[1], rtol=1e-4)
    np.testing.assert_array_equal(ranks[0]["losses"], ranks[1]["losses"])
    errs = {}
    for name, ref in after1.items():
        np.testing.assert_array_equal(ranks[0][f"state/{name}"], ranks[1][f"state/{name}"], err_msg=name)
        got = ranks[0][f"state/{name}"]
        if name.startswith("grad/"):  # DDP's mean of the two ranks' gradients against the whole batch's
            errs[name] = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)
            continue
        if name.endswith(("running_mean", "running_var")):  # the global batch's moments
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max(), err_msg=name)
            continue
        # A first AdamTF step moves a weight by u(g) = -lr g / (|g| + eps / sqrt(1 - b2)), monotone in g: the
        # weights agree as far as that maps the gradients' agreement (below), plus the float32 rounding of the
        # update (4 ulps of lr) and of the weight (2 ulps).
        g = after1[f"grad/{name}"].astype(np.float64)
        delta = 3e-4 * np.abs(g).max()

        def u(x):
            return -LR * x / (np.abs(x) + 1e-7 / np.sqrt(1.0 - 0.999))

        bound = (np.maximum(np.abs(u(g + delta) - u(g)), np.abs(u(g - delta) - u(g)))
                 + 4 * np.spacing(np.float32(LR)) + 2 * np.spacing(np.abs(ref)))
        assert np.all(np.abs(got - ref) <= bound), name
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 3e-4, (worst, errs[worst])


def test_naive_average_of_rank_losses_is_not_the_global_keypoint_loss(two_ranks_and_one):
    """What the global normalisation repairs: each half's own keypoint loss, averaged, misses the one-process
    loss by far more than the tolerance above."""
    from casapose_tpu_torch.train import device_batch, forward_and_loss
    from tests.torch_parity import port_train_model

    _, _, flat, _, _, batch, cfg, ranks, (losses1, _) = two_ranks_and_one
    halves = []
    for rows in (slice(0, B // 2), slice(B // 2, B)):
        model = port_train_model(flat, OC, K)
        with torch.no_grad():
            losses, _ = forward_and_loss(model, device_batch({k: v[rows] for k, v in batch.items()}, "cpu"), cfg,
                                         _port_cfg(two_ranks_and_one[3], two_ranks_and_one[4])[1], train=True)
        halves.append(float(losses[4]))
    naive = np.mean(halves)
    assert abs(naive - losses1[0, 4]) > 1e-2 * abs(losses1[0, 4])
    np.testing.assert_allclose(ranks[0]["losses"][0, 4], losses1[0, 4], rtol=1e-5)


def test_one_process_step_against_jax(two_ranks_and_one):
    import jax
    import jax.numpy as jnp

    from casapose_tpu.core.optimizer import adam_tf
    from casapose_tpu.train import TrainState
    from casapose_tpu.train import build_train_step as jax_build_train_step

    jm, variables, _, jcfg, jlw, batch, _, _, (losses1, _) = two_ranks_and_one
    tx = adam_tf(LR)
    state = TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]), step=jnp.zeros([], jnp.int32))
    _, lj = jax_build_train_step(jm, tx, jcfg, jlw)(state, {k: jnp.asarray(v) for k, v in batch.items()},
                                                    jax.random.PRNGKey(0))
    np.testing.assert_allclose(losses1[0], np.asarray(lj), rtol=1e-4)


def test_global_batch_must_divide_by_the_ranks():
    from casapose_tpu_torch.parallel.mesh import DataParallel

    dp = DataParallel(rank=1, world_size=2, device=torch.device("cpu"))
    assert dp.rows(4) == slice(2, 4)
    with pytest.raises(ValueError, match="global batch"):
        dp.rows(3)


def test_trainer_under_torchrun_matches_one_process(tmp_path):
    """``torchrun --nproc_per_node 2 -m casapose_tpu_torch.train --device cpu`` (gloo) on a written scene against
    the trainer in one process at the same global batch of 2: rank 0 alone writes the CSVs and the checkpoint, and
    its logged losses are the global batch's (rtol 1e-4; ``--lr 1e-5`` as tests/test_torch_train_harness.py, so
    that the first AdamTF steps move every weight by little)."""
    import csv
    import subprocess
    import sys

    from tools.synthetic_scene import make_meshes, make_scene, object_names

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    make_meshes(str(tmp_path / "models"))
    make_scene(str(tmp_path / "data" / "000000"), str(tmp_path / "models"), n_images=4)
    flags = ["-c", os.path.join(root, "configs", "config_8.ini"), "--objects_to_copy_list", "",
             "--data", str(tmp_path / "data"), "--datatest", "", "--datameshes", str(tmp_path / "models"),
             "--object", ",".join(object_names()), "--imagesize", "32", "32", "--batchsize", "2", "--epochs", "1",
             "--train_validation_split", "1.0", "--workers", "1", "--pretrained", "0", "--lr", "1e-5",
             "--loginterval", "1", "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    runs = {}
    for tag, launcher in (("one", [sys.executable, "-m", "casapose_tpu_torch.train"]),
                          ("two", [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
                                   "--master_port", str(_free_port()), "-m", "casapose_tpu_torch.train"])):
        proc = subprocess.run([*launcher, *flags, "--outf", str(tmp_path / tag)], cwd=root, env=env,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        runs[tag] = proc.stdout
        with open(tmp_path / tag / "loss_train.csv") as f:
            runs[tag + "_rows"] = [[float(x) for x in r[2:7]] for r in list(csv.reader(f))[1:]]
    assert "data parallel: 2 ranks, global batch 2 (1 images a rank)" in runs["two"]
    assert runs["two"].count("== TRAINING == Finished epoch 1") == 1  # printed by rank 0 only
    assert len(runs["two_rows"]) == len(runs["one_rows"]) == 2  # written once, by rank 0
    np.testing.assert_allclose(runs["two_rows"], runs["one_rows"], rtol=1e-4)
    assert sorted(os.listdir(tmp_path / "two" / "training_checkpoints")) == ["step_1"]
