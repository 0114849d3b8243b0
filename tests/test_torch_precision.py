"""``--matmul_precision`` in the port: TF32 in cuBLAS and cuDNN as XLA's GPU backend reads the JAX flag.

``casapose_tpu/train.py:349-351`` and ``eval.py:253-254`` set
``jax_default_matmul_precision`` around their steps; on a GPU XLA computes
float32 dots and convolutions in float32 at ``highest`` and in TF32 at
``high`` and ``default``. The port's counterpart,
``core/numerics.py::matmul_precision``, sets
``torch.backends.cudnn.allow_tf32`` and ``torch.backends.cuda.matmul.allow_tf32``
so and restores both on exit; the train step (``build_train_step``,
``build_eval_step``) and the eval harness's step (``build_test_step``) run
inside it, and the pose and voting numerics that the JAX package pins to
float32 (its ``f32_precision`` and ``HIGHEST`` contractions) turn TF32 off
inside it, in their backward too (``f32_pinned``). On the CPU the flags
change no result, so these tests read the flags where the steps and the
matmuls of a backward run.
"""

import contextlib

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tests.torch_parity import single_torch_thread  # noqa: F401 (autouse)

TF32 = {"highest": False, "high": True, "default": True}


def _flags():
    return (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)


@contextlib.contextmanager
def _flags_set(value):
    saved = _flags()
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = value
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.parametrize("precision", sorted(TF32))
@pytest.mark.parametrize("before", [False, True])
def test_context_sets_and_restores(precision, before):
    from casapose_tpu_torch.core.numerics import f32_precision, matmul_precision

    with _flags_set(before):
        with matmul_precision(precision):
            assert _flags() == (TF32[precision],) * 2
            with f32_precision():
                assert _flags() == (False, False)
            assert _flags() == (TF32[precision],) * 2
        assert _flags() == (before, before)


def test_unknown_precision_is_refused():
    from casapose_tpu_torch.core.numerics import matmul_precision

    with pytest.raises(ValueError, match="highest"):
        with matmul_precision("bfloat16"):
            pass


def test_flag_parses_as_in_jax():
    from casapose_tpu.utils.config import parse_config as jax_parse
    from casapose_tpu_torch.train import step_config_from_opt
    from casapose_tpu_torch.utils.config import parse_config

    for value in sorted(TF32):
        flags = ["--object", "obj_000001", "--matmul_precision", value]
        assert parse_config(flags).matmul_precision == jax_parse(flags).matmul_precision == value
        assert step_config_from_opt(parse_config(flags), 1).matmul_precision == value
    with pytest.raises(SystemExit):
        parse_config(["--object", "obj_000001", "--matmul_precision", "fp16"])


def _recording(module, name, seen):
    """Wrap ``module.name`` so that each call records the TF32 flags it runs under."""
    fn = getattr(module, name)

    def wrapped(*args, **kwargs):
        seen.append((name, _flags()))
        return fn(*args, **kwargs)

    return wrapped


@pytest.mark.parametrize("precision", sorted(TF32))
def test_train_and_eval_steps_run_at_the_precision(precision):
    """The network and losses of the train and eval steps run at the flag's TF32 setting, LS voting's sums in
    float32 whatever it says, and the flags are restored after each step."""
    import dataclasses

    import casapose_tpu_torch.ops.voting as voting
    import casapose_tpu_torch.train as train
    from casapose_tpu_torch.core.optimizer import AdamTF
    from casapose_tpu_torch.losses.losses import LossWeights
    from casapose_tpu_torch.models.registry import get_model
    from tests.torch_parity import step_configs, synthetic_train_batch

    _, cfg = step_configs(2, 3)
    cfg = dataclasses.replace(cfg, matmul_precision=precision)
    model = get_model("casapose_c_gcu5", ver_dim=9, seg_dim=3, device="cpu")
    batch = train.device_batch(synthetic_train_batch(2, 32, 32, 2, 3), "cpu")
    seen = []
    with pytest.MonkeyPatch.context() as mp, _flags_set(not TF32[precision]):
        mp.setattr(train, "prepare_device_batch", _recording(train, "prepare_device_batch", seen))
        mp.setattr(voting, "einsum_sums", _recording(voting, "einsum_sums", seen))
        train.build_train_step(model, AdamTF(model.parameters(), 1e-3), cfg, LossWeights())(batch)
        train.build_eval_step(model, cfg, LossWeights(), pose_validation=False)(batch)
        assert _flags() == (not TF32[precision],) * 2
    network = [f for name, f in seen if name == "prepare_device_batch"]
    assert network == [(TF32[precision],) * 2] * 2
    sums = [f for name, f in seen if name == "einsum_sums"]
    assert sums and all(f == (TF32[precision],) * 2 for f in sums)  # the call site; inside, see the next test


def test_voting_sums_are_float32_inside():
    """``einsum_sums`` (LS voting's contractions, HIGHEST in JAX) runs with TF32 off under any flag."""
    from casapose_tpu_torch.core.numerics import matmul_precision
    from casapose_tpu_torch.ops import voting

    seen = []
    rng = np.random.default_rng(0)
    hot = torch.from_numpy(rng.integers(0, 2, (1, 4, 4, 2)).astype(np.float32))
    dirs = torch.from_numpy(rng.normal(size=(1, 4, 4, 6)).astype(np.float32))
    conf = torch.from_numpy(rng.normal(size=(1, 4, 4, 3)).astype(np.float32))
    with pytest.MonkeyPatch.context() as mp, matmul_precision("high"):
        einsum = torch.einsum
        mp.setattr(torch, "einsum", lambda *a: (seen.append(_flags()), einsum(*a))[1])
        voting.einsum_sums(hot, dirs, conf, False)
    assert seen and all(f == (False, False) for f in seen)


class _MatmulFlags(TorchDispatchMode):
    """Records the TF32 flags at every matmul and convolution that runs under it, those of a backward included."""

    OPS = {"mm", "bmm", "addmm", "baddbmm", "convolution", "convolution_backward"}

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ in self.OPS:
            self.seen.append((func.overloadpacket.__name__, _flags()))
        return func(*args, **(kwargs or {}))


def _pinned_cases():
    """(function, its arguments) for each function on the train step's gradient path that JAX pins to float32."""
    from casapose_tpu_torch.ops import voting
    from casapose_tpu_torch.pose import geometry

    rng = np.random.default_rng(0)
    t = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32))  # noqa: E731
    hot = torch.from_numpy(rng.integers(0, 2, (1, 4, 4, 2)).astype(np.float32))
    cols = [t(2, 1) for _ in range(8)]
    return {
        "einsum_sums": (voting.einsum_sums, (hot, t(1, 4, 4, 6), t(1, 4, 4, 3), False)),
        "rodrigues": (geometry.rodrigues, (t(3, 3),)),
        "project_batch": (geometry.project_batch, (t(2, 5, 3), t(3, 3), t(2, 3, 4))),
        "transform_points_back_batch": (geometry.transform_points_back_batch, (t(2, 5, 2), *cols)),
    }


@pytest.mark.parametrize("name", ["einsum_sums", "rodrigues", "project_batch", "transform_points_back_batch"])
def test_pinned_functions_are_float32_in_their_gradient(name):
    """At ``high``, the matmuls of a pinned function's backward run with TF32 off (JAX's HIGHEST dots keep their
    precision in the transposed dots of the gradient), and the gradient is the unpinned function's."""
    from casapose_tpu_torch.core.numerics import matmul_precision

    fn, args = _pinned_cases()[name]
    grads = {}
    for pinned in (True, False):
        leaves = [a.clone().requires_grad_(not (name == "einsum_sums" and i == 0))  # not einsum_sums' class mask
                  if isinstance(a, torch.Tensor) else a for i, a in enumerate(args)]
        with matmul_precision("high"):
            out = (fn if pinned else fn.__wrapped__)(*leaves)
            outs = out if isinstance(out, tuple) else (out,)
            loss = sum((o * torch.linspace(-1.0, 1.0, o.numel()).reshape(o.shape)).sum() for o in outs)
            rec = _MatmulFlags()
            with rec:
                loss.backward()
            assert _flags() == (True, True)
        if pinned:
            assert rec.seen and all(f == (False, False) for _, f in rec.seen), rec.seen
        grads[pinned] = [a.grad for a in leaves if isinstance(a, torch.Tensor) and a.requires_grad]
    for a, b in zip(grads[True], grads[False]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("precision", sorted(TF32))
def test_eval_harness_step_runs_at_the_precision(precision):
    import casapose_tpu_torch.eval as ev
    from casapose_tpu_torch.models.registry import get_model
    from casapose_tpu_torch.utils.config import parse_config
    from tests.torch_parity import synthetic_train_batch

    opt = parse_config(["--object", "obj_000001,obj_000002", "--estimate_confidence", "1", "--estimate_coords", "1",
                        "--no_points", "3", "--matmul_precision", precision, "--min_object_size_test", "1"])
    model = get_model("casapose_c_gcu5", ver_dim=9, seg_dim=3, device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in synthetic_train_batch(1, 32, 32, 2, 3).items()}
    verts, counts = np.zeros((2, 8, 3), np.float32), np.array([[8], [8]], np.int32)
    seen = []
    with pytest.MonkeyPatch.context() as mp, _flags_set(not TF32[precision]):
        mp.setattr(ev, "prepare_device_batch", _recording(ev, "prepare_device_batch", seen))
        step = ev.build_test_step(model, opt, 2, verts, counts, ev.loss_weights_from_opt(opt))
        out = step(batch)
        assert _flags() == (not TF32[precision],) * 2
    assert seen == [("prepare_device_batch", (TF32[precision],) * 2)]
    assert torch.isfinite(out["losses"]).all()
