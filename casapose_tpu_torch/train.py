"""Training engine: the train and eval steps and the epoch loop.

Counterpart of ``casapose_tpu/train.py``. One train step:

  host batch (uint8 images, GT arrays)
    -> device finishing (colour jitter when imgaug is off, normalisation,
       noise, one-hot masks; data/pipeline.py)
    -> GT direction fields (ops/vectorfield.py)
    -> network forward with batch-statistics BatchNorm (models/)
    -> LS voting in its differentiable einsum form + keypoint reprojection
       loss, with BPnP (the PnP kernel forward, the implicit-function
       backward) under ``use_bpnp_reprojection_loss``
    -> composite loss, ``backward()``, ``AdamTF.step()``.

    python -m casapose_tpu_torch.train -c configs/config_8.ini --data ... --datatest ... --datameshes ... [--device cpu]

takes the flags of ``train_casapose.py`` and writes the same ``loss_train.csv``,
``loss_test.csv``, ``train_summary.csv`` and ``test_summary.csv``, checkpoints
under ``<outf>/<net>/step_<epoch>`` and the ``.npz`` weights under
``<outf>/frozen_model``. It runs on one card unless ``--device cpu`` is
given. Not ported yet, and raising if asked for (ROADMAP queue 1): data
parallelism over several cards, ``--remat``, the weight surgery
(``copy_weights_*``), ``.h5`` weights and the ImageNet ``.h5`` backbone,
``--profile_dir``, ``--save_debug_batch`` and a ``--matmul_precision`` other
than highest. The ``.h5`` export of every ``saveinterval`` is replaced by the
``.npz``, with a line that says so.
"""

import argparse
import dataclasses
import datetime
import os
import sys
import time

import numpy as np
import torch

from casapose_tpu_torch.core.checkpoint import load_weights_npz, restore_checkpoint, save_checkpoint, save_weights_npz
from casapose_tpu_torch.core.device import resolve_device
from casapose_tpu_torch.core.numerics import f32_precision
from casapose_tpu_torch.core.optimizer import AdamTF
from casapose_tpu_torch.data.pipeline import prepare_device_batch
from casapose_tpu_torch.losses.losses import composite_loss, keypoint_reprojection_loss
from casapose_tpu_torch.losses.schedules import LossWeightHandler, make_lr_schedule
from casapose_tpu_torch.models.casapose import init_weights
from casapose_tpu_torch.models.registry import build_model_from_opt
from casapose_tpu_torch.ops.vectorfield import get_all_vectorfields
from casapose_tpu_torch.ops.voting import ls_voting
from casapose_tpu_torch.pose.evaluation import estimate_and_evaluate_poses, evaluate_pose_estimates

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


def init_model(model, seed=0):
    """Draw ``model``'s weights again from ``seed`` (he-uniform convs, identity norms); returns the model."""
    return init_weights(model, torch.Generator().manual_seed(seed))


def forward_and_loss(model, batch, cfg, loss_weights, train, generator=None, draws=None, pose_estimation=False,
                     min_num_eval=200):
    """The forward pass and loss shared by the train and eval steps (``casapose_tpu/train.py::forward_and_loss``).

    ``batch`` is a dict of tensors on the model's device. ``train`` selects
    batch-statistics BatchNorm, the random batch finishing (from
    ``generator`` or the given ``draws``, see ``prepare_device_batch``), the
    confidence regularisation and the loader's filtered segmentation in the
    vertex and proxy losses. Returns ([loss, mask, vertex, proxy, keypoint],
    aux).
    """
    model.train(train)
    seg_dim = cfg.no_objects + 1
    k = cfg.no_points
    img, target_seg = prepare_device_batch(
        batch["img"], batch["seg"], seg_dim, generator=generator if train else None, draws=draws if train else None,
        noise=cfg.noise if train else 0.0, brightness=cfg.brightness, contrast=cfg.contrast,
        saturation=cfg.saturation, hue=cfg.hue, color_jitter=train and not cfg.use_imgaug,
        grayscale_to_rgb=not cfg.color_dataset,
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
            confidence_regularization=cfg.confidence_regularization and train,
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


def build_train_step(model, optimizer, cfg, loss_weights):
    """One optimizer step: ``step(batch, generator=None, draws=None) -> losses [5]`` (detached, on the device).

    Forward with batch statistics (the BatchNorm buffers update in it),
    ``loss.backward()``, ``optimizer.step()``, in full float32 (TF32 off).
    """
    if cfg.remat:
        raise NotImplementedError("--remat is not ported yet (ROADMAP queue 1): under torch.utils.checkpoint the "
                                  "recomputed forward would update the BatchNorm running statistics twice")

    def step(batch, generator=None, draws=None):
        optimizer.zero_grad(set_to_none=True)
        with f32_precision():
            losses, _ = forward_and_loss(model, batch, cfg, loss_weights, train=True, generator=generator,
                                         draws=draws)
            losses[0].backward()
            optimizer.step()
        return torch.stack([x.detach() for x in losses])

    return step


def build_eval_step(model, cfg, loss_weights, pose_validation, min_num_eval=200):
    """``step(batch) -> {"losses": [5], "pose_stats": 8 x [oc] when pose_validation}``, running BatchNorm statistics."""

    @torch.no_grad()
    def step(batch):
        with f32_precision():
            losses, aux = forward_and_loss(model, batch, cfg, loss_weights, train=False,
                                           pose_estimation=pose_validation, min_num_eval=min_num_eval)
        out = {"losses": torch.stack(losses)}
        if pose_validation:
            out["pose_stats"] = aux["pose_stats"]
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
    )


def _check_ported(opt):
    """Raise for the options of the JAX trainer that the port does not run (ROADMAP queue 1)."""
    unported = {
        "remat": bool(getattr(opt, "remat", False)),
        "profile_dir": bool(getattr(opt, "profile_dir", None)),
        "save_debug_batch": bool(opt.save_debug_batch),
        "weight surgery (copy_weights_from_backup_network / copy_weights_add_confidence_maps)":
            bool(opt.copy_weights_from_backup_network or opt.copy_weights_add_confidence_maps),
        "matmul_precision other than highest": getattr(opt, "matmul_precision", "highest") != "highest",
        "pretrained with an ImageNet .h5 ($CASAPOSE_IMAGENET_H5)":
            bool(opt.pretrained) and bool(os.environ.get("CASAPOSE_IMAGENET_H5")),
    }
    asked = [name for name, on in unported.items() if on]
    if asked:
        raise NotImplementedError(f"casapose_tpu_torch.train: not ported yet (ROADMAP queue 1): {', '.join(asked)}")


def device_batch(batch, dev):
    """A host batch (numpy) as tensors on ``dev``, float64 arrays as float32 (as JAX stores them), without image_id."""
    out = {}
    for key, v in batch.items():
        if key != "image_id":
            t = torch.as_tensor(v)
            out[key] = (t.float() if t.dtype == torch.float64 else t).to(dev)
    return out


def run_training(opt, device="cuda"):
    """The training driver (``casapose_tpu/train.py::run_training``); returns a :class:`TrainState`."""
    from casapose_tpu_torch.data.ndds import VectorfieldDataset

    _check_ported(opt)
    dev = resolve_device(device)
    print("start:", datetime.datetime.now().time())
    if dev.type == "cuda" and torch.cuda.device_count() > 1:
        print(f"{torch.cuda.device_count()} cards visible: data parallelism is not ported yet (ROADMAP queue 1); "
              f"training on {dev} alone")
    checkpoint_path = os.path.join(opt.outf, opt.net)
    frozen_path = os.path.join(opt.outf, "frozen_model")
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
        seed=opt.manualseed,
    )
    print(f"training data: {train_batches} batches")
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
            seed=opt.manualseed + 1,
        )
        print(f"testing data: {test_batches} batches")
    try:
        return _train(opt, dev, trainingdata, int(train_batches), testingdata, int(test_batches), objectsofinterest,
                      checkpoint_path, frozen_path)
    finally:
        trainingdata.close()
        if testingdata is not None:
            testingdata.close()


def _train(opt, dev, trainingdata, train_batches, testingdata, test_batches, objectsofinterest, checkpoint_path,
           frozen_path):
    no_objects = len(objectsofinterest)
    model = build_model_from_opt(opt, no_objects, device=dev, generator=torch.Generator().manual_seed(opt.manualseed))
    if opt.pretrained:
        print("pretrained=1: the ImageNet backbone import (.h5) is not ported yet (ROADMAP queue 1); "
              "training from random init")

    lr_schedule = make_lr_schedule(opt.lr, opt.lr_decay, opt.lr_epochs, opt.lr_epochs_start, opt.lr_epochs_steps,
                                   train_batches)
    if opt.load_h5_weights:
        fname = os.path.join(frozen_path, opt.load_h5_filename)
        if os.path.exists(fname + ".npz"):
            n, _ = load_weights_npz(fname + ".npz", model)
            print(f"loaded {n} arrays from {fname}.npz")
        elif os.path.exists(fname + ".h5"):
            raise NotImplementedError(f"{fname}.h5: .h5 weights are not ported yet (ROADMAP queue 1); convert them "
                                      "with util_scripts/convert_h5_weights.py on a host with JAX and h5py")
    optimizer = AdamTF(model.parameters(), lr_schedule)

    start_epoch = 1
    restored = restore_checkpoint(checkpoint_path, model, optimizer)
    if restored is not None:
        start_epoch = restored + 1
        print(f"restored checkpoint at epoch {restored}")

    loss_handler = LossWeightHandler(
        mask_loss_weight=opt.mask_loss_weight, vertex_loss_weight=opt.vertex_loss_weight,
        proxy_loss_weight=opt.proxy_loss_weight, kp_loss_weight=opt.keypoint_loss_weight,
        filter_vertex_with_segmentation=opt.filter_vertex_with_segmentation,
        filter_high_proxy_errors=opt.filter_high_proxy_errors,
    )
    loss_weights = loss_handler.as_loss_weights()
    cfg = step_config_from_opt(opt, no_objects)
    train_step = build_train_step(model, optimizer, cfg, loss_weights)
    eval_step = build_eval_step(model, cfg, loss_weights, pose_validation=False)
    eval_pose_step = build_eval_step(model, cfg, loss_weights, pose_validation=True)

    for name, hdr in (
        ("loss_train.csv", "epoch,batchid,loss,mask_loss,vertex_loss,proxy_loss,keypoint_loss,"
                           "mask_loss_weight,vertex_loss_weight,proxy_loss_weight, kp_loss_weight\n"),
        ("loss_test.csv", "epoch,batchid,loss,mask_loss,vertex_loss,proxy_loss,keypoint_loss,"
                          "mask_loss_weight,vertex_loss_weight,proxy_loss_weight, kp_loss_weight\n"),
        ("train_summary.csv", "epoch,learning_rate,loss,mask_loss,vertex_loss,proxy_loss,keypoint_loss\n"),
    ):
        with open(os.path.join(opt.outf, name), "w") as f:
            f.write(hdr)
    with open(os.path.join(opt.outf, "test_summary.csv"), "w") as f:
        f.write("epoch,learning_rate,loss,mask_loss,vertex_loss,proxy_loss,keypoint_loss"
                + "".join(f",2d_{o}" for o in objectsofinterest) + "".join(f",3d_{o}" for o in objectsofinterest)
                + "\n")

    generator = torch.Generator(device=dev).manual_seed(opt.manualseed)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def log_batch(namefile, epoch, batch_idx, losses):
        with open(os.path.join(opt.outf, namefile), "a") as f:
            f.write("{}, {},{:.15f},{:.7f},{:.7f},{:.7f},{:.7f},{:.4f},{:.4f},{:.4f},{:.4f}\n".format(
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

        for batch_idx in range(train_batches):
            batch = trainingdata.get_next()
            pending.append((batch_idx, train_step(device_batch(batch, dev), generator)))
            train_images += batch["img"].shape[0]
            if (batch_idx + 1) % opt.loginterval == 0:
                flush_pending()
                print(f"{datetime.datetime.now().time()}  Train Epoch: {epoch}, Batch idx: {batch_idx + 1}, "
                      f"Epoch Loss: {epoch_loss[0] / (batch_idx + 1):.15f}")
                print(f"Time {time.time() - t0}")
                t0 = time.time()
        flush_pending()
        sync()
        train_seconds += time.time() - t_epoch
        epoch_loss /= max(train_batches, 1)
        lr_now = optimizer.learning_rate()
        print("==========================")
        print(f"== TRAINING == Finished epoch {epoch} (lr={lr_now:.7f}) with total loss: {epoch_loss[0]:.7f} "
              f"--- mask: {epoch_loss[1]:.7f}, vector: {epoch_loss[2]:.7f}, proxy: {epoch_loss[3]:.7f}, "
              f"keypoint: {epoch_loss[4]:.7f} ==")
        with open(os.path.join(opt.outf, "train_summary.csv"), "a") as f:
            f.write(f"{epoch},{lr_now},{epoch_loss[0]:.7f},{epoch_loss[1]:.7f},{epoch_loss[2]:.7f},"
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
            print(f"== VALIDATION == Finished epoch {epoch} with total loss: {epoch_loss[0]:.7f} "
                  f"--- mask: {epoch_loss[1]:.7f}, vector: {epoch_loss[2]:.7f}, proxy: {epoch_loss[3]:.7f}, "
                  f"keypoint: {epoch_loss[4]:.7f} ==")
            s = (f"{epoch},{lr_now},{epoch_loss[0]:.7f},{epoch_loss[1]:.7f},{epoch_loss[2]:.7f},"
                 f"{epoch_loss[3]:.7f},{epoch_loss[4]:.7f}")
            if pose_validation:
                with np.errstate(divide="ignore", invalid="ignore"):
                    err_2d = np.nan_to_num(acc[0] / acc[2])
                    err_3d = np.nan_to_num(acc[1] / acc[2])
                print(f"2D Valid: {err_2d}")
                print(f"2D Valid (mean): {err_2d.mean()}")
                print(f"3D Valid: {err_3d}")
                print(f"3D Valid (mean): {err_3d.mean()}")
                s += "".join(f",{e:.4f}" for e in err_2d) + "".join(f",{e:.4f}" for e in err_3d)
            with open(os.path.join(opt.outf, "test_summary.csv"), "a") as f:
                f.write(s + "\n")
        print("==========================")

        if epoch % opt.saveinterval == 0:
            save_checkpoint(checkpoint_path, model, optimizer, epoch)
            save_weights_npz(os.path.join(frozen_path, "result_w.npz"), model)
            print(f"the .h5 export is not ported yet (ROADMAP queue 1); wrote {os.path.join(frozen_path, 'result_w.npz')}")

    save_checkpoint(checkpoint_path, model, optimizer, opt.epochs)
    step = optimizer.param_groups[0]["count"]
    if train_images:
        print(f"train: {train_images} images in {train_seconds:.2f}s of train epochs ({train_images / train_seconds:.2f} "
              f"img/s, host loader and logging included) on {dev}; {step} optimizer steps in all")
    print("end:", datetime.datetime.now().time())
    return TrainState(model=model, optimizer=optimizer, step=step)


def main(argv=None):
    """``python -m casapose_tpu_torch.train``: the flags of ``train_casapose.py``, plus ``--device``."""
    from casapose_tpu_torch.utils.config import parse_config

    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args, rest = pre.parse_known_args(argv)
    run_training(parse_config(rest), device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
