"""Shared helpers for the parity tests of casapose_tpu_torch against casapose_tpu.

Inputs are made with numpy from a seed and handed to both packages; JAX
weights are carried across with ``from_jax_variables``.
"""

import numpy as np

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


def jax_poses_pnp_accelerator_path(coords, seg, kp3, cam, no_objects):
    """The JAX ``poses_pnp`` down the branch it takes on an accelerator.

    There ``solve_pnp`` hands the whole solve to the fused Pallas PnP kernel
    (casapose_tpu/pose/epnp.py:453-460), whose algorithm the port's PnP
    kernel follows; on the CPU it takes its XLA algorithm instead. The
    backend check is answered "tpu" and the kernel runs in interpret mode,
    as tests/test_pnp_kernel.py runs it. ``solve_pnp`` is called untraced,
    so the check runs on this call.
    """
    import jax
    import pytest

    from casapose_tpu.ops import pnp_kernel
    from casapose_tpu.pose import epnp, evaluation

    calls = []
    kernel = pnp_kernel.solve_pnp_pallas

    def interpreted(*args, **kwargs):
        calls.append(1)
        return kernel(*args, interpret=True, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "default_backend", lambda: "tpu")
        mp.setattr(pnp_kernel, "solve_pnp_pallas", interpreted)
        mp.setattr(evaluation, "solve_pnp", epnp.solve_pnp.__wrapped__)
        poses = np.asarray(evaluation.poses_pnp(coords, seg, kp3, cam, no_objects))
    assert calls, "the JAX solve_pnp did not take its Pallas branch"
    return poses
