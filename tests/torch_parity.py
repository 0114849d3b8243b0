"""Shared helpers for the parity tests of casapose_tpu_torch against casapose_tpu.

Inputs are made with numpy from a seed and handed to both packages; JAX
weights are carried across with ``from_jax_variables``.
"""

import contextlib

import numpy as np
import pytest

CAMERA = np.array([[572.4, 0.0, 32.0], [0.0, 573.5, 24.0], [0.0, 0.0, 1.0]], np.float32)


def calibrated_variables(jax_model, img):
    """Flax variables of ``jax_model`` whose BatchNorm running statistics are the batch statistics of ``img``.

    With the init statistics (mean 0, var 1) random weights let activations
    grow layer after layer to ~1e3, where float32 rounding alone exceeds the
    port's tolerance. One train-mode pass gives each BatchNorm the statistics
    of its own input, as a trained network has: flax stores
    0.99 * old + 0.01 * batch, which is solved for the batch statistics.
    Returns the flattened numpy dict (``flatten_params`` format).
    """
    import jax
    import jax.numpy as jnp

    from casapose_tpu.core.checkpoint import flatten_params

    x = jnp.asarray(img)
    variables = jax.jit(lambda x: jax_model.init(jax.random.PRNGKey(0), x, train=False))(x)
    _, upd = jax.jit(lambda v, x: jax_model.apply(v, x, train=True, mutable=["batch_stats"]))(variables, x)
    flat = flatten_params(variables)
    for key, new in flatten_params({"batch_stats": upd["batch_stats"]}).items():
        flat[key] = ((new - 0.99 * flat[key]) / 0.01).astype(np.float32)
    return flat


def torch_model(flat, ver_dim, seg_dim):
    """The port's ``casapose_c_gcu5`` on the CPU, loaded with the flattened JAX variables."""
    from casapose_tpu_torch.core.convert import from_jax_variables
    from casapose_tpu_torch.models.registry import get_model

    model = get_model("casapose_c_gcu5", ver_dim=ver_dim, seg_dim=seg_dim, device="cpu")
    model.load_state_dict(from_jax_variables(flat, model))
    return model


def planted_pnp(B, N=9, seed=0, K=CAMERA):
    """(pts2d [B, N, 2], pts3d [B, N, 3], R [B, 3, 3], t [B, 3]): exact projections of random poses."""
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(seed)
    pts3d = rng.uniform(-0.06, 0.06, (B, N, 3)).astype(np.float32)
    R = Rotation.random(B, random_state=seed + 1).as_matrix().astype(np.float32)
    t = np.stack([rng.uniform(-0.1, 0.1, B), rng.uniform(-0.1, 0.1, B), rng.uniform(0.5, 1.2, B)], 1)
    t = t.astype(np.float32)
    uvw = (np.einsum("bij,bnj->bni", R, pts3d) + t[:, None]) @ K.T
    return (uvw[..., :2] / uvw[..., 2:]).astype(np.float32), pts3d, R, t


@contextlib.contextmanager
def jax_pnp_accelerator_branch():
    """Run the JAX ``solve_pnp`` down the branch it takes on an accelerator.

    There ``solve_pnp`` hands the whole solve to the fused Pallas PnP kernel
    (casapose_tpu/pose/epnp.py:453-460), whose algorithm the port's PnP
    kernel follows; on the CPU it takes its XLA algorithm instead. Inside
    this context the backend check is answered "tpu" and the kernel runs in
    interpret mode, as tests/test_pnp_kernel.py runs it. The jitted
    ``solve_pnp`` is swapped for its untraced function wherever a module has
    bound it (``pose/evaluation.py``, ``pose/bpnp.py``), so that the check
    runs on each call or trace. Yields the list of kernel calls made.
    """
    import jax

    from casapose_tpu.ops import pnp_kernel
    from casapose_tpu.pose import bpnp, epnp, evaluation

    calls = []
    kernel = pnp_kernel.solve_pnp_pallas

    def interpreted(*args, **kwargs):
        calls.append(1)
        return kernel(*args, interpret=True, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "default_backend", lambda: "tpu")
        mp.setattr(pnp_kernel, "solve_pnp_pallas", interpreted)
        for module in (evaluation, bpnp):
            mp.setattr(module, "solve_pnp", epnp.solve_pnp.__wrapped__)
        yield calls


def jax_poses_pnp_accelerator_path(coords, seg, kp3, cam, no_objects):
    """The JAX ``poses_pnp`` with its PnP down the accelerator branch (see :func:`jax_pnp_accelerator_branch`)."""
    from casapose_tpu.pose import evaluation

    with jax_pnp_accelerator_branch() as calls:
        poses = np.asarray(evaluation.poses_pnp(coords, seg, kp3, cam, no_objects))
    assert calls, "the JAX solve_pnp did not take its Pallas branch"
    return poses


def jax_ransac_draws(mask, vn, max_iter, round_hyp_num=512, max_num=30000, key=0):
    """The random numbers that ``casapose_tpu/pose/ransac.py`` draws from ``PRNGKey(key)`` for ``mask``
    [b, h, w, oc], as the port's ``draws=`` takes them (torch tensors).

    The JAX function splits the key into one key per (image, class), each into
    a candidate key (uniform noise over the pixels) and a hypothesis key (one
    key per round, candidate indices below the pair's valid-candidate count).
    """
    import jax
    import torch

    mask = np.asarray(mask, np.float32)
    b, h, w, oc = mask.shape
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(key), b * oc)).reshape(b, oc, 2)
    noise = np.zeros((b, oc, h * w), np.float32)
    hyps = np.zeros((b, oc, max_iter, round_hyp_num, vn, 2), np.int64)
    n = min(max_num, h * w)
    for i in range(b):
        for o in range(oc):
            k_sel, k_hyp = jax.random.split(keys[i, o])
            noise[i, o] = np.asarray(jax.random.uniform(k_sel, (h * w,)))
            flat = mask[i, :, :, o].reshape(-1)
            _, idx = jax.lax.top_k(flat * 2.0 + noise[i, o], n)
            valid_n = max(int(np.sum(flat[np.asarray(idx)])), 1)
            for r, kr in enumerate(jax.random.split(k_hyp, max_iter)):
                hyps[i, o, r] = np.asarray(jax.random.randint(kr, (round_hyp_num, vn, 2), 0, valid_n))
    return {"noise": torch.from_numpy(noise), "hypotheses": torch.from_numpy(hyps)}


@contextlib.contextmanager
def port_ransac_with_jax_draws():
    """Inside, the port's ``estimate_and_evaluate_poses`` votes with the draws the JAX package makes from its
    default ``PRNGKey(0)`` (see :func:`jax_ransac_draws`), as every JAX eval step does. Yields the list of calls."""
    from casapose_tpu_torch.pose import evaluation

    calls = []
    ransac = evaluation.ransac_voting_layer_all_masks

    def with_jax_draws(mask, vertex, round_hyp_num=512, max_iter=1, max_num=30000, **kwargs):
        calls.append(1)
        draws = jax_ransac_draws(mask.cpu().numpy(), vertex.shape[3], max_iter, round_hyp_num, max_num)
        return ransac(mask, vertex, round_hyp_num, max_iter=max_iter, max_num=max_num, draws=draws,
                      **{k: v for k, v in kwargs.items() if k not in ("draws", "generator")})

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(evaluation, "ransac_voting_layer_all_masks", with_jax_draws)
        yield calls
