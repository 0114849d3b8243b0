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


# ----------------------------------------------------------------------------- training slice

TRAIN_CFG = dict(  # __graft_entry__.py::build_synthetic_train_case's step configuration
    estimate_confidence=True, estimate_coords=True, train_vectors_with_ground_truth=True,
    use_bpnp_reprojection_loss=False, confidence_regularization=True, separated_vectorfields=False,
    max_keypoint_pixel_error=12.5, noise=0.0, brightness=0.001, contrast=0.001, saturation=0.001, hue=0.001,
    use_imgaug=True,
)


def synthetic_train_batch(b=2, h=32, w=32, no_objects=2, k=3, seed=0, focal=60.0):
    """``__graft_entry__.py::make_synthetic_batch`` (random dense labels), float arrays as float32."""
    from __graft_entry__ import make_synthetic_batch

    batch = make_synthetic_batch(np.random.default_rng(seed), b, h, w, no_objects, k, focal=focal)
    return {key: v.astype(np.float32) if v.dtype == np.float64 else v for key, v in batch.items()}


def step_configs(no_objects, k, **overrides):
    """The same step configuration for both packages: (JAX StepConfig, port StepConfig)."""
    from casapose_tpu.train import StepConfig as JaxStepConfig
    from casapose_tpu_torch.train import StepConfig

    fields = dict(TRAIN_CFG, no_objects=no_objects, no_points=k, **overrides)
    return JaxStepConfig(**fields), StepConfig(**fields)


def jax_train_variables(h, w, no_objects, k, seed=0, dtype=None):
    """(flax model, variables) of ``casapose_c_gcu5`` initialised as the JAX trainer does (``init_model``)."""
    import jax
    import jax.numpy as jnp

    from casapose_tpu.models.registry import get_model

    model = get_model("casapose_c_gcu5", ver_dim=3 * k, seg_dim=1 + no_objects, **({"dtype": dtype} if dtype else {}))
    variables = jax.jit(lambda x, g: model.init(jax.random.PRNGKey(seed), x, g, train=False))(
        jnp.zeros((1, h, w, 3), jnp.float32), jnp.zeros((1, h, w, 1 + no_objects), jnp.float32))
    return model, variables


def port_train_model(flat, no_objects, k, dtype=None):
    """The port's ``casapose_c_gcu5`` on the CPU with the flattened JAX variables."""
    from casapose_tpu_torch.core.convert import from_jax_variables
    from casapose_tpu_torch.models.registry import get_model

    model = get_model("casapose_c_gcu5", ver_dim=3 * k, seg_dim=1 + no_objects, device="cpu", dtype=dtype)
    model.load_state_dict(from_jax_variables(flat, model))
    return model


def port_grads(flat, batch, cfg, lw, double=False):
    """(losses [5] numpy, {name: grad}) of the port's ``forward_and_loss(train=True)``, in float64 if ``double``.

    The float64 run is the exact function the float32 runs of both packages
    approximate: the batch finishing's outputs, the model and the batch's
    float arrays are taken to float64.
    """
    import torch

    import casapose_tpu_torch.train as train
    from casapose_tpu_torch.train import device_batch, forward_and_loss

    no_objects, k = cfg.no_objects, cfg.no_points
    model = port_train_model(flat, no_objects, k)
    tb = device_batch(batch, "cpu")
    with pytest.MonkeyPatch.context() as mp:
        if double:
            model = model.double()
            tb = {key: v.double() if v.is_floating_point() else v for key, v in tb.items()}
            prepare = train.prepare_device_batch
            mp.setattr(train, "prepare_device_batch", lambda *a, **kw: tuple(x.double() for x in prepare(*a, **kw)))
        losses, _ = forward_and_loss(model, tb, cfg, lw, train=True)
        losses[0].backward()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).double().numpy()
             for n, p in model.named_parameters()}
    return torch.stack(losses).detach().double().numpy(), grads


def jax_grads(jax_model, variables, batch, cfg, lw):
    """(losses [5] numpy, {port name: grad}) of the JAX ``forward_and_loss(train=True)`` under ``jax.grad``."""
    import jax
    import jax.numpy as jnp

    from casapose_tpu.core.checkpoint import flatten_params
    from casapose_tpu.train import forward_and_loss
    from casapose_tpu_torch.core.convert import from_jax_variables

    jb = {key: jnp.asarray(v) for key, v in batch.items()}

    def loss_fn(params):
        losses, _ = forward_and_loss(jax_model, params, variables["batch_stats"], jb, cfg, lw, None, train=True)
        return losses[0], jnp.stack(losses)

    g, losses = jax.jit(jax.grad(loss_fn, has_aux=True))(variables["params"])
    grads = {n: v.double().numpy() for n, v in from_jax_variables(flatten_params({"params": g})).items()}
    return np.asarray(losses, np.float64), grads


def train_mode_votes(flat, batch, cfg):
    """The points [b, oc, k, 2] (y, x) that the port's train step votes on ``batch`` (batch-statistics BatchNorm)."""
    import torch

    from casapose_tpu_torch.data.pipeline import prepare_device_batch
    from casapose_tpu_torch.ops.voting import ls_voting
    from casapose_tpu_torch.train import device_batch

    seg_dim, k = cfg.no_objects + 1, cfg.no_points
    model = port_train_model(flat, cfg.no_objects, k).train()
    tb = device_batch(batch, "cpu")
    with torch.no_grad():
        img, tseg = prepare_device_batch(tb["img"], tb["seg"], seg_dim)
        out = model(img, tseg)
        return ls_voting(tseg, out[..., seg_dim : seg_dim + 2 * k], out[..., seg_dim + 2 * k :], num_points=k).numpy()


def plant_train_keypoints(batch, coords, seed=5, depth=(0.75, 0.85), noise_px=0.05):
    """``batch`` with well-posed PnP problems for the voted points ``coords`` (as ``chip_smoke.py::plant_keypoints``).

    Each object's model keypoints go where a random pose projects them onto
    its voted points moved by N(0, ``noise_px``) pixels, through the batch's
    camera: the solve is unique, and the reprojection residuals are well
    above float32 rounding, so that the gradient of their norm (the BPnP
    loss) has a direction rounding does not decide. ``poses_gt`` is that
    pose moved by (6, -4, 8) cm, and ``keypoints2d`` its projections.
    """
    from scipy.spatial.transform import Rotation

    b, oc, k, _ = coords.shape
    n = b * oc
    rng = np.random.default_rng(seed)
    K = batch["camera"][0].astype(np.float64)
    R = Rotation.random(n, random_state=seed).as_matrix()
    t = np.stack([rng.uniform(-0.05, 0.05, n), rng.uniform(-0.05, 0.05, n), rng.uniform(*depth, n)], 1)
    xy = coords.reshape(n, k, 2)[..., ::-1].astype(np.float64) + rng.normal(0.0, noise_px, (n, k, 2))
    xy1 = np.concatenate([xy, np.ones((n, k, 1))], -1)
    cam_pts = (xy1 @ np.linalg.inv(K).T) * rng.uniform(*depth, (n, k, 1))
    model_pts = np.einsum("bji,bnj->bni", R, cam_pts - t[:, None])
    t_gt = t + [0.06, -0.04, 0.08]
    uvw = (np.einsum("nij,nkj->nki", R, model_pts) + t_gt[:, None]) @ K.T
    out = dict(batch)
    out["keypoints3d"] = model_pts.reshape(b, oc, 1, k, 3).astype(np.float32)
    out["poses_gt"] = np.concatenate([R, t_gt[:, :, None]], -1).reshape(b, oc, 1, 3, 4).astype(np.float32)
    out["keypoints2d"] = (uvw[..., :2] / uvw[..., 2:])[..., ::-1].reshape(b, oc, 1, k, 2).astype(np.float32)
    return out


def gradient_errors(grads, exact):
    """Per tensor, max |g - exact| over max |exact| (0 where the exact gradient is all zero)."""
    out = {}
    for name, g in grads.items():
        scale = np.abs(exact[name]).max()
        out[name] = float(np.abs(g - exact[name]).max() / scale) if scale > 0 else float(np.abs(g).max())
    return out


@pytest.fixture(scope="module", autouse=True)
def single_torch_thread():
    """Run a module's torch work on one thread, restored after it (autouse where imported).

    The suite runs several workers on a few cores; torch's OpenMP threads
    spin while they wait, so with every worker on all cores small tensor
    work slows down many times over.
    """
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
