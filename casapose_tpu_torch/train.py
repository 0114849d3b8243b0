"""Training engine: the train and eval steps and the epoch loop.

Counterpart of ``casapose_tpu/train.py``. One train step:

  host batch (uint8 images, GT arrays)
    -> device finishing (colour jitter when imgaug is off, normalisation,
       noise, one-hot masks; data/pipeline.py)
    -> GT direction fields (ops/vectorfield.py)
    -> network forward with batch-statistics BatchNorm (models/), under
       ``torch.utils.checkpoint`` with ``--remat``
    -> LS voting in its differentiable einsum form + keypoint reprojection
       loss, with BPnP (the PnP kernel forward, the implicit-function
       backward) under ``use_bpnp_reprojection_loss``
    -> composite loss, ``backward()``, ``AdamTF.step()``,
  at ``--matmul_precision`` (``highest``: TF32 off; ``high``/``default``: TF32).

    python -m casapose_tpu_torch.train -c configs/config_8.ini --data ... --datatest ... --datameshes ... [--device cpu]
    torchrun --nproc_per_node N -m casapose_tpu_torch.train -c ... --batchsize <global batch>

takes the flags of ``train_casapose.py`` and writes the same ``loss_train.csv``,
``loss_test.csv``, ``train_summary.csv`` and ``test_summary.csv``, checkpoints
under ``<outf>/<net>/step_<epoch>``, the ``.npz`` weights under
``<outf>/frozen_model`` and, where h5py imports, the Keras ``.h5`` beside
them. It runs on the card unless ``--device cpu`` is given; under
``torchrun`` each process trains on its card (``cuda:LOCAL_RANK``) with its
rows of the global batch, data-parallel as the JAX trainer's mesh
(``parallel/mesh.py``). Every option of the JAX trainer runs: the ImageNet
backbone (``--pretrained``, from a local ``.h5``), ``.h5`` and ``.npz``
weights, the weight surgery, ``--save_debug_batch`` and ``--profile_dir``
(a ``torch.profiler`` Chrome trace).
"""

import argparse
import dataclasses
import datetime
import os
import sys
import time

import numpy as np
import torch
from torch.nn.parallel import DistributedDataParallel
from torch.utils.checkpoint import checkpoint

from casapose_tpu_torch.core.checkpoint import (
    apply_expansion_surgery,
    copy_weights_vertex,
    export_keras_h5,
    h5py_available,
    import_keras_h5,
    load_imagenet_backbone,
    load_weights_npz,
    restore_checkpoint,
    save_checkpoint,
    save_weights_npz,
)
from casapose_tpu_torch.core.device import resolve_device
from casapose_tpu_torch.core.numerics import matmul_precision
from casapose_tpu_torch.core.optimizer import AdamTF
from casapose_tpu_torch.data.pipeline import prepare_device_batch
from casapose_tpu_torch.losses.losses import composite_loss, keypoint_reprojection_loss
from casapose_tpu_torch.losses.schedules import LossWeightHandler, make_lr_schedule
from casapose_tpu_torch.models.casapose import init_weights
from casapose_tpu_torch.models.layers import remat_context_fn
from casapose_tpu_torch.models.registry import build_model_from_opt, get_model
from casapose_tpu_torch.ops.vectorfield import get_all_vectorfields
from casapose_tpu_torch.ops.voting import ls_voting
from casapose_tpu_torch.parallel.mesh import (
    all_reduce_mean,
    all_reduce_sum,
    init_data_parallel,
    shutdown,
    sync_batchnorm,
)
from casapose_tpu_torch.pose.evaluation import estimate_and_evaluate_poses, evaluate_pose_estimates
from casapose_tpu_torch.utils.profiler import ProfileWindow

def _cache_records_enabled(opt):
    """--cache_records unset (None) means on for training, as in the JAX trainer."""
    v = getattr(opt, "cache_records", None)
    return True if v is None else bool(v)


@dataclasses.dataclass
class TrainState:
    """What ``run_training`` returns: the model, its optimizer and the number of optimizer steps taken."""

    model: torch.nn.Module
    optimizer: AdamTF
    step: int


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """Static configuration of the train and eval steps (the JAX package's fields)."""

    no_objects: int
    no_points: int
    estimate_confidence: bool
    estimate_coords: bool
    train_vectors_with_ground_truth: bool
    use_bpnp_reprojection_loss: bool
    confidence_regularization: bool
    separated_vectorfields: bool
    max_keypoint_pixel_error: float
    noise: float
    brightness: float
    contrast: float
    saturation: float
    hue: float
    use_imgaug: bool
    color_dataset: bool = True
    remat: bool = False
    matmul_precision: str = "highest"


def init_model(model, seed=0):
    """Draw ``model``'s weights again from ``seed`` (he-uniform convs, identity norms); returns the model."""
    return init_weights(model, torch.Generator().manual_seed(seed))


class RematNetwork(torch.nn.Module):
    """The network forward under ``torch.utils.checkpoint`` (``--remat``, the JAX step's ``jax.checkpoint``): the
    backward pass recomputes the activations instead of keeping them, and BatchNorm's running statistics update in
    the first forward only (``models/layers.py::remat_context_fn``)."""

    def __init__(self, net):
        super().__init__()
        self.net = net

    def forward(self, img, gt_seg=None):
        return checkpoint(self.net, img, gt_seg, use_reentrant=False, context_fn=remat_context_fn)


def forward_and_loss(model, batch, cfg, loss_weights, train, generator=None, draws=None, pose_estimation=False,
                     min_num_eval=200, data_parallel=None):
    """The forward pass and loss shared by the train and eval steps (``casapose_tpu/train.py::forward_and_loss``).

    ``model`` is the network, or what :func:`build_train_step` wraps it in
    (:class:`RematNetwork`, ``DistributedDataParallel``). ``batch`` is a dict
    of tensors on the model's device: all of the batch, or with
    ``data_parallel`` this rank's rows of the global batch. ``train`` selects
    batch-statistics BatchNorm, the random batch finishing (from
    ``generator`` or the given ``draws``, see ``prepare_device_batch``), the
    confidence regularisation and the loader's filtered segmentation in the
    vertex and proxy losses. Returns ([loss, mask, vertex, proxy, keypoint],
    aux); with ``data_parallel`` the mean of each loss over the ranks is the
    global batch's.
    """
    model.train(train)
    seg_dim = cfg.no_objects + 1
    k = cfg.no_points
    b = batch["img"].shape[0]
    rows = None if data_parallel is None else (data_parallel.rank * b, data_parallel.world_size * b)
    img, target_seg = prepare_device_batch(
        batch["img"], batch["seg"], seg_dim, generator=generator if train else None, draws=draws if train else None,
        noise=cfg.noise if train else 0.0, brightness=cfg.brightness, contrast=cfg.contrast,
        saturation=cfg.saturation, hue=cfg.hue, color_jitter=train and not cfg.use_imgaug,
        grayscale_to_rgb=not cfg.color_dataset, rows=rows,
    )
    keypoints2d, keypoints3d, cam_mat = batch["keypoints2d"], batch["keypoints3d"], batch["camera"]
    filtered_seg, poses_gt = batch["seg"], batch["poses_gt"]
    target_dirs = get_all_vectorfields(target_seg, keypoints2d, filtered_seg, cfg.separated_vectorfields)

    output_net = model(img, target_seg if cfg.train_vectors_with_ground_truth else None)
    output_seg = output_net[..., :seg_dim]
    if cfg.estimate_confidence:
        output_dirs = output_net[..., seg_dim : seg_dim + 2 * k]
        confidence = output_net[..., seg_dim + 2 * k :]
    else:
        output_dirs = output_net[..., seg_dim:]
        confidence = None

    kp_loss = poses_est = points_est = None
    if cfg.estimate_coords:
        voting_seg = target_seg if cfg.train_vectors_with_ground_truth else output_seg
        coords = ls_voting(voting_seg, output_dirs, confidence, num_points=k)
        kp_loss, poses_est, points_est = keypoint_reprojection_loss(
            coords, output_seg, poses_gt, keypoints3d, target_seg, cam_mat, batch["offsets"], confidence,
            max_pixel_error=cfg.max_keypoint_pixel_error, min_num=50,
            use_bpnp_reprojection_loss=cfg.use_bpnp_reprojection_loss,
            estimate_poses=cfg.use_bpnp_reprojection_loss if train else True,
            confidence_regularization=cfg.confidence_regularization and train, data_parallel=data_parallel,
        )

    losses = composite_loss(
        output_seg, target_seg, output_dirs, target_dirs, keypoints2d, loss_weights,
        filtered_seg=filtered_seg if train else None,
        pixel_gt_count=batch["pixel_gt_count"] if train else None, kp_loss=kp_loss,
    )
    aux = {"output_seg": output_seg, "output_dirs": output_dirs, "poses_est": poses_est, "points_est": points_est,
           "target_seg": target_seg}
    if pose_estimation:
        if cfg.estimate_coords:
            aux["pose_stats"], _, _ = evaluate_pose_estimates(
                points_est, poses_est, poses_gt, target_seg, keypoints3d, cam_mat, batch["diameters"],
                min_num=min_num_eval)
        else:
            aux["pose_stats"], _, _ = estimate_and_evaluate_poses(
                output_seg, target_seg, output_dirs, poses_gt, keypoints3d, cam_mat, batch["diameters"],
                batch["offsets"], min_num=min_num_eval)
    return losses, aux


def build_train_step(model, optimizer, cfg, loss_weights, data_parallel=None):
    """One optimizer step: ``step(batch, generator=None, draws=None) -> losses [5]`` (detached, on the device).

    Forward with batch statistics (the BatchNorm buffers update in it),
    ``loss.backward()``, ``optimizer.step()``, at ``cfg.matmul_precision``;
    with ``cfg.remat`` the forward runs under :class:`RematNetwork`. With
    ``data_parallel`` (a group of any size) the network runs under
    ``DistributedDataParallel`` and ``batch`` is this rank's rows of the
    global batch: BatchNorm takes the global batch's moments, every rank
    steps AdamTF with the same averaged gradient, and the losses returned are
    the global batch's on every rank.
    """
    net = RematNetwork(model) if cfg.remat else model
    if data_parallel is not None:
        sync_batchnorm(model, data_parallel)
        dev = next(model.parameters()).device
        # Neither find_unused_parameters nor a static graph: every parameter reaches the loss through the one
        # tensor the network returns (segmentation, directions and confidences concatenated), so every step gives
        # each a gradient, zero where a loss is off (tests/test_torch_ddp_params.py: every registry model, and
        # the flags that bypass a head, a loss or decoder 2's predicted mask). broadcast_buffers off: the running
        # statistics update from the global moments, the same on every rank, as flax's under JAX's mesh.
        # Gradients as views of DDP's buckets, made before the first backward and zeroed in place: autograd then
        # adds each gradient into its bucket. Without that, a 1x1 conv's weight gradient arrives in channels-last
        # strides that differ from its parameter's, and DDP warns and copies it into the bucket every step.
        for p in model.parameters():
            if p.requires_grad:
                p.grad = torch.zeros_like(p)
        net = DistributedDataParallel(net, device_ids=[dev.index] if dev.type == "cuda" else None,
                                      broadcast_buffers=False, gradient_as_bucket_view=True)

    def step(batch, generator=None, draws=None):
        optimizer.zero_grad(set_to_none=data_parallel is None)  # under DDP the gradients stay the buckets' views
        with matmul_precision(cfg.matmul_precision):
            losses, _ = forward_and_loss(net, batch, cfg, loss_weights, train=True, generator=generator,
                                         draws=draws, data_parallel=data_parallel)
            losses[0].backward()
            optimizer.step()
        return all_reduce_mean(torch.stack([x.detach() for x in losses]), data_parallel)

    return step


def build_eval_step(model, cfg, loss_weights, pose_validation, min_num_eval=200, data_parallel=None):
    """``step(batch) -> {"losses": [5], "pose_stats": 8 x [oc] when pose_validation}``, running BatchNorm statistics.

    With ``data_parallel``, ``batch`` is this rank's rows of the global batch;
    the losses are averaged and the pose statistics summed over the ranks, so
    every rank returns the global batch's (pose validation is reduced, not
    left to rank 0).
    """

    @torch.no_grad()
    def step(batch):
        with matmul_precision(cfg.matmul_precision):
            losses, aux = forward_and_loss(model, batch, cfg, loss_weights, train=False,
                                           pose_estimation=pose_validation, min_num_eval=min_num_eval,
                                           data_parallel=data_parallel)
        out = {"losses": all_reduce_mean(torch.stack(losses), data_parallel)}
        if pose_validation:
            out["pose_stats"] = [all_reduce_sum(x, data_parallel) for x in aux["pose_stats"]]
        return out

    return step


def step_config_from_opt(opt, no_objects):
    return StepConfig(
        no_objects=no_objects,
        no_points=opt.no_points,
        estimate_confidence=bool(opt.estimate_confidence),
        estimate_coords=bool(opt.estimate_coords),
        train_vectors_with_ground_truth=bool(opt.train_vectors_with_ground_truth),
        use_bpnp_reprojection_loss=bool(opt.use_bpnp_reprojection_loss),
        confidence_regularization=bool(opt.confidence_regularization),
        separated_vectorfields=opt.modelname == "pvnet",
        max_keypoint_pixel_error=float(opt.max_keypoint_pixel_error),
        noise=float(opt.noise),
        brightness=float(opt.brightness),
        contrast=float(opt.contrast),
        saturation=float(opt.saturation),
        hue=float(opt.hue),
        use_imgaug=bool(opt.use_imgaug),
        color_dataset=bool(opt.color_dataset),
        remat=bool(getattr(opt, "remat", False)),
        matmul_precision=getattr(opt, "matmul_precision", "highest") or "highest",
    )


def device_batch(batch, dev):
    """A host batch (numpy) as tensors on ``dev``, float64 arrays as float32 (as JAX stores them), without image_id."""
    out = {}
    for key, v in batch.items():
        if key != "image_id":
            t = torch.as_tensor(v)
            out[key] = (t.float() if t.dtype == torch.float64 else t).to(dev)
    return out


def run_training(opt, device="cuda", data_parallel=None):
    """The training driver (``casapose_tpu/train.py::run_training``); returns a :class:`TrainState`, or None after
    ``--save_debug_batch``.

    With ``data_parallel`` (``parallel/mesh.py::init_data_parallel``) this
    process is one rank of a data-parallel group: it trains on
    ``data_parallel.device`` with its rows of each global batch of
    ``--batchsize``, and only rank 0 writes files.
    """
    from casapose_tpu_torch.data.ndds import VectorfieldDataset

    dev = resolve_device(device) if data_parallel is None else data_parallel.device
    rows = None if data_parallel is None else data_parallel.rows(opt.batchsize)
    main_rank = data_parallel is None or data_parallel.rank == 0
    say = print if main_rank else (lambda *args, **kwargs: None)
    say("start:", datetime.datetime.now().time())
    if data_parallel is not None:
        say(f"data parallel: {data_parallel.world_size} ranks, global batch {opt.batchsize} "
            f"({rows.stop - rows.start} images a rank)")
    checkpoint_path = os.path.join(opt.outf, opt.net)
    frozen_path = os.path.join(opt.outf, "frozen_model")
    if main_rank:
        for p in (opt.outf, checkpoint_path, frozen_path):
            os.makedirs(p, exist_ok=True)
        with open(os.path.join(opt.outf, "header.txt"), "w") as f:
            f.write(str(opt))

    np.random.seed(opt.manualseed)
    objectsofinterest = [x.strip() for x in opt.object.split(",")]
    no_objects = len(objectsofinterest)
    use_split = opt.data == opt.datatest
    separated = opt.modelname == "pvnet"
    cache = _cache_records_enabled(opt)

    train_dataset = VectorfieldDataset(
        root=opt.data, path_meshes=opt.datameshes, path_filter_root=opt.data_path_filter, color_input=opt.color_dataset,
        no_points=opt.no_points, objectsofinterest=objectsofinterest, noise=opt.noise,
        random_translation=(opt.translation, opt.translation), random_rotation=opt.rotation, use_train_split=use_split,
        train_validation_split=opt.train_validation_split, output_folder=opt.outf, use_imgaug=opt.use_imgaug,
        random_crop=True, separated_vectorfields=separated, contrast=opt.contrast, brightness=opt.brightness,
        hue=opt.hue, saturation=opt.saturation, wxyz_quaterion_input=opt.data_wxyz_quaterion,
        record_cache_dir=os.path.join(opt.outf, "record_cache", "train") if cache else None,
    )
    trainingdata, train_batches = train_dataset.generate_dataset(
        opt.batchsize, opt.epochs, opt.prefetch, opt.imagesize, opt.crop_factor, opt.workers, no_objects,
        seed=opt.manualseed, rows=rows,
    )
    say(f"training data: {train_batches} batches")
    if opt.save_debug_batch:
        from casapose_tpu_torch.utils.visualization import save_batches

        try:
            if main_rank:
                save_batches(trainingdata, os.path.join(opt.outf, "visual_batch"))
        finally:
            trainingdata.close()
        say("saved debug batch; exiting (save_debug_batch)")
        return None
    testingdata, test_batches = None, 0
    if opt.datatest:
        test_dataset = VectorfieldDataset(
            root=opt.datatest, path_meshes=opt.datameshes, path_filter_root=opt.datatest_path_filter,
            color_input=opt.color_dataset, no_points=opt.no_points, objectsofinterest=objectsofinterest, noise=0.00001,
            random_translation=(0, 0), random_rotation=0, use_validation_split=use_split,
            train_validation_split=opt.train_validation_split, output_folder=opt.outf, random_crop=False,
            separated_vectorfields=separated, wxyz_quaterion_input=opt.datatest_wxyz_quaterion,
            record_cache_dir=os.path.join(opt.outf, "record_cache", "test") if cache else None,
        )
        testingdata, test_batches = test_dataset.generate_dataset(
            opt.batchsize, opt.epochs, opt.prefetch, opt.imagesize, opt.crop_factor, opt.workers, no_objects,
            seed=opt.manualseed + 1, rows=rows,
        )
        say(f"testing data: {test_batches} batches")
    try:
        return _train(opt, dev, trainingdata, int(train_batches), testingdata, int(test_batches), objectsofinterest,
                      checkpoint_path, frozen_path, data_parallel, say)
    finally:
        trainingdata.close()
        if testingdata is not None:
            testingdata.close()


def _load_frozen_weights(fname, model):
    """``fname``.npz, else ``fname``.h5, into ``model``: (arrays loaded, the file read), or (0, None) if neither
    exists."""
    if os.path.exists(fname + ".npz"):
        return load_weights_npz(fname + ".npz", model)[0], fname + ".npz"
    if os.path.exists(fname + ".h5"):
        return import_keras_h5(fname + ".h5", model)[0], fname + ".h5"
    return 0, None


def _weight_surgery(opt, model, no_objects, frozen_path, dev, say):
    """The JAX trainer's weight surgery (``casapose_tpu/train.py:483-516``), on ``model`` in place: copy the
    segmentation conv's rows and the CLADE tables from a trained network with fewer objects, or the direction
    channels of one trained without confidence maps."""
    add_confidence = bool(opt.copy_weights_add_confidence_maps and opt.estimate_confidence)
    ver_dim = model.ver_dim
    seg_dim = 1 + (no_objects if add_confidence else opt.objects_in_input_network)
    backup = get_model(opt.modelname, ver_dim=ver_dim - opt.no_points if add_confidence else ver_dim, seg_dim=seg_dim,
                       base_model=opt.backbonename, device=dev,
                       generator=torch.Generator().manual_seed(opt.manualseed))
    fname = os.path.join(frozen_path, opt.load_h5_filename)
    n, found = _load_frozen_weights(fname, backup)
    if found is None:
        raise FileNotFoundError(f"backup network weights not found at {fname}.(npz|h5)")
    say(f"loaded backup network ({n} arrays)")
    if add_confidence:
        state = copy_weights_vertex(model.state_dict(), backup.state_dict(), ver_dim - opt.no_points)
    else:
        state = apply_expansion_surgery(model.state_dict(), backup.state_dict(), opt.objects_to_copy)
    model.load_state_dict(state)


def _train(opt, dev, trainingdata, train_batches, testingdata, test_batches, objectsofinterest, checkpoint_path,
           frozen_path, data_parallel, say):
    no_objects = len(objectsofinterest)
    main_rank = data_parallel is None or data_parallel.rank == 0
    model = build_model_from_opt(opt, no_objects, device=dev, generator=torch.Generator().manual_seed(opt.manualseed))
    if opt.pretrained:
        n_bb = load_imagenet_backbone(model, base_model=opt.backbonename)
        if n_bb:
            say(f"initialized backbone from imagenet weights ({n_bb} arrays)")
        else:
            say("pretrained=1 but imagenet weights unavailable; training from random init")

    lr_schedule = make_lr_schedule(opt.lr, opt.lr_decay, opt.lr_epochs, opt.lr_epochs_start, opt.lr_epochs_steps,
                                   train_batches)
    if opt.load_h5_weights:
        n, found = _load_frozen_weights(os.path.join(frozen_path, opt.load_h5_filename), model)
        if found is not None:
            say(f"{'loaded' if found.endswith('.npz') else 'imported'} {n} arrays from {found}")
    if opt.copy_weights_from_backup_network or opt.copy_weights_add_confidence_maps:
        _weight_surgery(opt, model, no_objects, frozen_path, dev, say)
    optimizer = AdamTF(model.parameters(), lr_schedule)

    start_epoch = 1
    restored = restore_checkpoint(checkpoint_path, model, optimizer)
    if restored is not None:
        start_epoch = restored + 1
        say(f"restored checkpoint at epoch {restored}")

    loss_handler = LossWeightHandler(
        mask_loss_weight=opt.mask_loss_weight, vertex_loss_weight=opt.vertex_loss_weight,
        proxy_loss_weight=opt.proxy_loss_weight, kp_loss_weight=opt.keypoint_loss_weight,
        filter_vertex_with_segmentation=opt.filter_vertex_with_segmentation,
        filter_high_proxy_errors=opt.filter_high_proxy_errors,
    )
    loss_weights = loss_handler.as_loss_weights()
    cfg = step_config_from_opt(opt, no_objects)
    train_step = build_train_step(model, optimizer, cfg, loss_weights, data_parallel)
    eval_step = build_eval_step(model, cfg, loss_weights, pose_validation=False, data_parallel=data_parallel)
    eval_pose_step = build_eval_step(model, cfg, loss_weights, pose_validation=True, data_parallel=data_parallel)

    def write(name, text, mode="a"):
        if main_rank:
            with open(os.path.join(opt.outf, name), mode) as f:
                f.write(text)

    for name, hdr in (
        ("loss_train.csv", "epoch,batchid,loss,mask_loss,vertex_loss,proxy_loss,keypoint_loss,"
                           "mask_loss_weight,vertex_loss_weight,proxy_loss_weight, kp_loss_weight\n"),
        ("loss_test.csv", "epoch,batchid,loss,mask_loss,vertex_loss,proxy_loss,keypoint_loss,"
                          "mask_loss_weight,vertex_loss_weight,proxy_loss_weight, kp_loss_weight\n"),
        ("train_summary.csv", "epoch,learning_rate,loss,mask_loss,vertex_loss,proxy_loss,keypoint_loss\n"),
    ):
        write(name, hdr, "w")
    write("test_summary.csv", "epoch,learning_rate,loss,mask_loss,vertex_loss,proxy_loss,keypoint_loss"
          + "".join(f",2d_{o}" for o in objectsofinterest) + "".join(f",3d_{o}" for o in objectsofinterest) + "\n",
          "w")

    generator = torch.Generator(device=dev).manual_seed(opt.manualseed)  # the same draws on every rank
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def log_batch(namefile, epoch, batch_idx, losses):
        write(namefile, "{}, {},{:.15f},{:.7f},{:.7f},{:.7f},{:.7f},{:.4f},{:.4f},{:.4f},{:.4f}\n".format(
            epoch, batch_idx + 1, losses[0], losses[1], losses[2], losses[3], losses[4],
            loss_handler.mask_loss_weight, loss_handler.vertex_loss_weight, loss_handler.proxy_loss_weight,
            loss_handler.kp_loss_weight))

    train_images, train_seconds = 0, 0.0
    for epoch in range(start_epoch, opt.epochs + 1):
        # Per-batch losses stay on the device and are written once per loginterval (one host sync each).
        epoch_loss = np.zeros(5)
        pending = []
        t0 = t_epoch = time.time()

        def flush_pending():
            nonlocal epoch_loss
            for b_idx, loss_dev in pending:
                loss_np = loss_dev.cpu().numpy().astype(np.float64)
                epoch_loss += loss_np
                log_batch("loss_train.csv", epoch, b_idx, loss_np)
            pending.clear()

        # --profile_dir: steps min(10, n - 1) to +5 of the first epoch's n, clamped for short epochs, as JAX traces
        first = min(10, max(train_batches - 1, 0))
        profiler = ProfileWindow(getattr(opt, "profile_dir", None) if epoch == start_epoch and main_rank else None,
                                 first, min(first + 5, train_batches), dev, "train_trace")
        for batch_idx in range(train_batches):
            profiler.before(batch_idx)
            batch = trainingdata.get_next()
            pending.append((batch_idx, train_step(device_batch(batch, dev), generator)))
            train_images += batch["img"].shape[0] * (1 if data_parallel is None else data_parallel.world_size)
            if (batch_idx + 1) % opt.loginterval == 0:
                flush_pending()
                say(f"{datetime.datetime.now().time()}  Train Epoch: {epoch}, Batch idx: {batch_idx + 1}, "
                    f"Epoch Loss: {epoch_loss[0] / (batch_idx + 1):.15f}")
                say(f"Time {time.time() - t0}")
                t0 = time.time()
        profiler.close()  # the epoch ended before the window's end (a short epoch)
        flush_pending()
        sync()
        train_seconds += time.time() - t_epoch
        epoch_loss /= max(train_batches, 1)
        lr_now = optimizer.learning_rate()
        say("==========================")
        say(f"== TRAINING == Finished epoch {epoch} (lr={lr_now:.7f}) with total loss: {epoch_loss[0]:.7f} "
            f"--- mask: {epoch_loss[1]:.7f}, vector: {epoch_loss[2]:.7f}, proxy: {epoch_loss[3]:.7f}, "
            f"keypoint: {epoch_loss[4]:.7f} ==")
        write("train_summary.csv", f"{epoch},{lr_now},{epoch_loss[0]:.7f},{epoch_loss[1]:.7f},{epoch_loss[2]:.7f},"
              f"{epoch_loss[3]:.7f},{epoch_loss[4]:.7f}\n")

        if testingdata is not None:
            pose_validation = epoch % opt.validationinterval == 0
            vstep = eval_pose_step if pose_validation else eval_step
            epoch_loss = np.zeros(5)
            acc = np.zeros((6, no_objects))
            for batch_idx in range(test_batches):
                out = vstep(device_batch(testingdata.get_next(), dev))
                losses = out["losses"].cpu().numpy().astype(np.float64)
                epoch_loss += losses
                log_batch("loss_test.csv", epoch, batch_idx, losses)
                if pose_validation:
                    ps = [x.cpu().numpy() for x in out["pose_stats"]]
                    for row, i in enumerate((0, 1, 2, 7, 4, 5)):  # valid 2d, 3d, gt count, fp (row 7), err 2d, 3d
                        acc[row] += ps[i]
            epoch_loss /= max(test_batches, 1)
            say(f"== VALIDATION == Finished epoch {epoch} with total loss: {epoch_loss[0]:.7f} "
                f"--- mask: {epoch_loss[1]:.7f}, vector: {epoch_loss[2]:.7f}, proxy: {epoch_loss[3]:.7f}, "
                f"keypoint: {epoch_loss[4]:.7f} ==")
            s = (f"{epoch},{lr_now},{epoch_loss[0]:.7f},{epoch_loss[1]:.7f},{epoch_loss[2]:.7f},"
                 f"{epoch_loss[3]:.7f},{epoch_loss[4]:.7f}")
            if pose_validation:
                with np.errstate(divide="ignore", invalid="ignore"):
                    err_2d = np.nan_to_num(acc[0] / acc[2])
                    err_3d = np.nan_to_num(acc[1] / acc[2])
                say(f"2D Valid: {err_2d}")
                say(f"2D Valid (mean): {err_2d.mean()}")
                say(f"3D Valid: {err_3d}")
                say(f"3D Valid (mean): {err_3d.mean()}")
                s += "".join(f",{e:.4f}" for e in err_2d) + "".join(f",{e:.4f}" for e in err_3d)
            write("test_summary.csv", s + "\n")
        say("==========================")

        if epoch % opt.saveinterval == 0 and main_rank:
            save_checkpoint(checkpoint_path, model, optimizer, epoch)
            npz = os.path.join(frozen_path, "result_w.npz")
            save_weights_npz(npz, model)
            if h5py_available():
                export_keras_h5(os.path.join(frozen_path, "result_w.h5"), model)
            else:
                say(f"h5py is not installed: wrote {npz} and no .h5")

    if main_rank:
        save_checkpoint(checkpoint_path, model, optimizer, opt.epochs)
    step = optimizer.param_groups[0]["count"]
    if train_images:
        say(f"train: {train_images} images in {train_seconds:.2f}s of train epochs ({train_images / train_seconds:.2f} "
            f"img/s, host loader and logging included) on {dev}"
            + ("" if data_parallel is None else f" and {data_parallel.world_size - 1} more ranks")
            + f"; {step} optimizer steps in all")
    say("end:", datetime.datetime.now().time())
    return TrainState(model=model, optimizer=optimizer, step=step)


def main(argv=None):
    """``python -m casapose_tpu_torch.train``: the flags of ``train_casapose.py``, plus ``--device``. Under
    ``torchrun`` each process joins the group that its environment describes and trains on its card."""
    from casapose_tpu_torch.utils.config import parse_config

    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args, rest = pre.parse_known_args(argv)
    opt = parse_config(rest)
    if "WORLD_SIZE" not in os.environ:  # not launched by torchrun
        run_training(opt, device=args.device)
        return 0
    resolve_device(args.device)
    data_parallel = init_data_parallel(args.device)
    try:
        run_training(opt, device=args.device, data_parallel=data_parallel)
    finally:
        shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
