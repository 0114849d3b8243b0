"""Evaluation harness: ADD(-S)/2D metrics, losses, timing, BOP export.

Counterpart of ``casapose_tpu/eval.py``. Every model of the registry, on
every backbone, in float32 or bfloat16 (``--compute_dtype``), through one of
two branches:
  * least squares (``estimate_coords 1``, the confidence channels required):
    network forward -> CC-filtered LS voting -> keypoint reprojection loss
    with the PnP solve inside -> ADD(-S)/2D metrics; on the card the voting
    sums and the PnP solve are the hand-written CUDA kernels;
  * RANSAC (``estimate_coords 0``, the branch that serves PVNet): network
    forward -> RANSAC voting (``--ransac_rounds``) -> PnP (the CUDA kernel)
    -> metrics.
Both add the losses and the per-object sums.

    python -m casapose_tpu_torch.eval -c configs/config_8.ini --datatest ... --datameshes ... [--device cpu]

takes the flags of ``test_casapose.py`` and writes the same
``loss_test_eval.csv`` and ``test_summary_eval.csv`` (the BOP pose files
under ``--write_poses 1``, the visual dumps under ``--save_eval_batches 1``,
a ``torch.profiler`` Chrome trace of batches 1-5 under ``--profile_dir``).
It runs on the card unless ``--device cpu`` is given, at
``--matmul_precision``. Weights come from the JAX package's ``.npz`` export,
a Keras ``.h5`` (where h5py imports) or a checkpoint of ``python -m
casapose_tpu_torch.train``. ``--quantized_inference int8`` runs the
network's convolutions int8-quantized (``ops/quant.py``). Refused: orbax
checkpoints (the JAX package's ``save_weights_npz`` exports them).
"""

import argparse
import glob
import os
import sys
import time

import numpy as np
import torch

from casapose_tpu_torch.core.checkpoint import (
    checkpoint_file,
    import_keras_h5,
    latest_checkpoint_step,
    load_weights_npz,
    restore_checkpoint,
)
from casapose_tpu_torch.core.device import resolve_device
from casapose_tpu_torch.core.numerics import matmul_precision
from casapose_tpu_torch.data.pipeline import prepare_device_batch
from casapose_tpu_torch.losses.losses import LossWeights, composite_loss, keypoint_reprojection_loss, proxy_voting_dist
from casapose_tpu_torch.models.registry import build_model_from_opt
from casapose_tpu_torch.ops.quant import quantized_apply
from casapose_tpu_torch.ops.vectorfield import get_all_vectorfields
from casapose_tpu_torch.ops.voting import ls_voting
from casapose_tpu_torch.pose.evaluation import estimate_and_evaluate_poses, evaluate_pose_estimates
from casapose_tpu_torch.utils.profiler import ProfileWindow


def _check_ported(opt):
    """Raise for a combination the JAX harness cannot run either."""
    if opt.estimate_coords and not opt.estimate_confidence:
        # The JAX step passes confidence=None to ls_voting here and fails in its softplus (a TypeError).
        raise ValueError("casapose_tpu_torch.eval: least-squares voting (estimate_coords 1) weighs the votes with "
                         "the confidence channels; without them (estimate_confidence 0) use estimate_coords 0 (RANSAC)")


def loss_weights_from_opt(opt):
    """The loss weights the harness reports with (the JAX harness leaves the two filters off)."""
    return LossWeights(mask_loss_weight=opt.mask_loss_weight, vertex_loss_weight=opt.vertex_loss_weight,
                       proxy_loss_weight=opt.proxy_loss_weight, kp_loss_weight=opt.keypoint_loss_weight)


def build_test_step(model, opt, no_objects, mesh_vertex_array, mesh_vertex_count, loss_weights):
    """The evaluation step.

    Args:
      model: a model of the port's registry in eval mode, on its device.
      opt: parsed config (``utils/config.py``).
      mesh_vertex_array, mesh_vertex_count: [oc, V, 3] and [oc, 1] eval meshes.
    Returns:
      ``step(batch)``: batch is a dict of tensors on the model's device
      (``img`` uint8 [b, h, w, c], ``seg`` [b, h, w, 1], ``keypoints2d``,
      ``keypoints3d``, ``camera``, ``diameters``, ``offsets``, ``poses_gt``)
      -> dict with ``losses`` [5], ``pose_stats`` (8 x [oc]) and the per-image
      outputs of the JAX step (``proxy_dist`` too under
      ``--save_eval_batches``). With ``--eval_chunk c`` the batch runs in
      chunks of c images (and a tail chunk): losses are the image-weighted
      mean over chunks, pose stats are sums.
    """
    _check_ported(opt)
    seg_dim = 1 + no_objects
    k = opt.no_points
    separated = opt.modelname == "pvnet"  # one direction-field stack per object, as the JAX step
    dev = next(model.parameters()).device
    mesh_vertex_array = torch.as_tensor(np.asarray(mesh_vertex_array), dtype=torch.float32, device=dev)
    mesh_vertex_count = torch.as_tensor(np.asarray(mesh_vertex_count), device=dev)

    @torch.no_grad()
    def _eval_batch(batch):
        with matmul_precision(getattr(opt, "matmul_precision", "highest") or "highest"):
            img, target_seg = prepare_device_batch(batch["img"], batch["seg"], seg_dim, grayscale_to_rgb=not opt.color_dataset)
            target_vertex = batch["keypoints2d"]
            target_dirs = get_all_vectorfields(target_seg, target_vertex, batch["seg"], separated)
            gt_seg_input = target_seg if opt.train_vectors_with_ground_truth else None
            if getattr(opt, "quantized_inference", "") == "int8":
                output_net = quantized_apply(model, img, gt_seg_input)
            else:
                output_net = model(img, gt_seg_input)
            output_seg = output_net[..., :seg_dim]
            if opt.estimate_confidence:
                output_dirs = output_net[..., seg_dim : seg_dim + 2 * k]
                confidence = output_net[..., seg_dim + 2 * k :]
            else:
                output_dirs = output_net[..., seg_dim:]
                confidence = None

            kp_loss = None
            if opt.estimate_coords:
                coords = ls_voting(
                    target_seg if opt.train_vectors_with_ground_truth else output_seg,
                    output_dirs,
                    confidence,
                    num_points=k,
                    filter_estimates=bool(opt.confidence_filter_estimates),
                    output_second_largest_component=bool(opt.confidence_choose_second),
                    cc_downsample=int(getattr(opt, "cc_filter_downsample", 4)),
                    raw_output=output_net,
                )
                kp_loss, poses_est, points_est = keypoint_reprojection_loss(
                    coords, output_seg, batch["poses_gt"], batch["keypoints3d"], target_seg, batch["camera"],
                    batch["offsets"], confidence,
                    min_num=opt.min_object_size_test,
                    min_num_gt=1,
                    use_bpnp_reprojection_loss=bool(opt.use_bpnp_reprojection_loss),
                    estimate_poses=True,
                    filter_with_gt=bool(opt.filter_test_with_gt),
                )
                pose_stats, estimated_poses, estimated_points = evaluate_pose_estimates(
                    points_est, poses_est, batch["poses_gt"], target_seg, batch["keypoints3d"], batch["camera"],
                    batch["diameters"], evaluation_points=mesh_vertex_array, object_points_3d_count=mesh_vertex_count,
                    min_num=1,
                )
                estimated_poses = estimated_poses[:, :, 0]
            else:
                pose_stats, estimated_poses, estimated_points = estimate_and_evaluate_poses(
                    output_seg, target_seg, output_dirs, batch["poses_gt"], batch["keypoints3d"], batch["camera"],
                    batch["diameters"], batch["offsets"], evaluation_points=mesh_vertex_array,
                    object_points_3d_count=mesh_vertex_count, min_num=1,
                    ransac_rounds=int(getattr(opt, "ransac_rounds", 20)),
                )
            losses = composite_loss(output_seg, target_seg, output_dirs, target_dirs, target_vertex, loss_weights,
                                    kp_loss=kp_loss)
            proxy_dist, object_loss_values = proxy_voting_dist(
                output_dirs, target_vertex, vertex_one_hot_weights=target_seg[:, :, :, 1:],
                vertex_weights=target_seg[:, :, :, 0:1], invert_weights=True,
            )
        extra = {"proxy_dist": proxy_dist} if opt.save_eval_batches else {}
        return {
            **extra,
            "losses": torch.stack(losses),
            "pose_stats": pose_stats,
            "proxy_per_object": object_loss_values,
            "estimated_poses": estimated_poses,
            "estimated_points": estimated_points,
            "output_seg": output_seg,
            "output_dirs": output_dirs,
            "target_dirs": target_dirs,
            "confidence": confidence if confidence is not None else torch.zeros_like(output_seg[..., :1]),
        }

    chunk = int(getattr(opt, "eval_chunk", 0) or 0)

    def _combine(outs):
        """Equal chunks: mean of the chunk losses, sums of the pose stats, per-image outputs concatenated."""
        return {
            key: torch.stack([o[key] for o in outs]).mean(0) if key == "losses"
            else [sum(x) for x in zip(*(o[key] for o in outs))] if key == "pose_stats"
            else torch.cat([o[key] for o in outs])
            for key in outs[0]
        }

    def step(batch):
        B = batch["img"].shape[0]
        if not (chunk and B > chunk):
            return _eval_batch(batch)
        rem = B % chunk
        head = _combine([_eval_batch({key: v[i : i + chunk] for key, v in batch.items()}) for i in range(0, B - rem, chunk)])
        if rem == 0:
            return head
        tail = _eval_batch({key: v[B - rem :] for key, v in batch.items()})
        out = _combine([head, tail])
        out["losses"] = (head["losses"] * (B - rem) + tail["losses"] * rem) / B  # image-weighted, as the JAX step
        return out

    return step


def load_weights_from_opt(opt, model):
    """Weights as the JAX harness finds them: ``--load_h5_weights`` (.npz, else .h5), else a checkpoint, else
    random."""
    if opt.load_h5_weights:
        fname = opt.load_h5_filename
        frozen = os.path.join(opt.outf, "frozen_model")
        for c in (fname + ".npz", os.path.join(frozen, fname + ".npz"), fname + ".h5", os.path.join(frozen, fname + ".h5")):
            if os.path.exists(c):
                n, _ = (load_weights_npz if c.endswith(".npz") else import_keras_h5)(c, model)
                print(f"loaded {n} arrays from {c}")
                return
        raise FileNotFoundError(f"no weights found for {fname} (.npz / .h5, also under {frozen})")
    if opt.net:
        ckpt = os.path.join(opt.outf, opt.net)
        step = latest_checkpoint_step(ckpt)
        if step is None:
            return
        if checkpoint_file(ckpt, step) is None:
            raise NotImplementedError(
                f"{ckpt}/step_{step}: an orbax checkpoint of the JAX package cannot be read here; export its weights "
                "with the JAX package's save_weights_npz and load the .npz (--load_h5_weights 1), or evaluate a "
                "checkpoint that python -m casapose_tpu_torch.train wrote")
        restore_checkpoint(ckpt, model, step=step)
        print(f"restored checkpoint {ckpt}/step_{step}")


def _save_eval_visuals(opt, batch, out, pose_stats, no_objects, batch_idx):
    """``--save_eval_batches``: the JAX harness's visual dumps of one batch under ``<evalf>/visual_batch_eval_mask``
    (estimated masks, fields and poses of the batch; per image, the pose comparison, the proxy-error maps and the
    proxy summary). ``add_correct`` is the batch's 3D-valid counts, as in the JAX harness."""
    from casapose_tpu_torch.utils.visualization import (
        save_eval_batch,
        save_mask_by_proxy_loss,
        save_pose_comparison,
        save_proxy_error_maps,
    )

    host = {key: v.cpu().numpy() for key, v in out.items() if torch.is_tensor(v)}
    visual_root = os.path.join(opt.evalf, "visual_batch_eval_mask")
    save_eval_batch(batch, host["output_seg"], host["target_dirs"], host["output_dirs"], host["estimated_poses"],
                    host["estimated_points"], no_objects, opt.no_points, path_out=visual_root,
                    confidence=host["confidence"], add_correct=pose_stats[1], batch_idx=batch_idx)
    imgs, tseg = (x.numpy() for x in prepare_device_batch(torch.as_tensor(batch["img"]), torch.as_tensor(batch["seg"]),
                                                          1 + no_objects, grayscale_to_rgb=not opt.color_dataset))
    ids = np.asarray(batch["image_id"]).reshape(-1)
    for bi in range(batch["img"].shape[0]):
        raw_id = ids[bi]
        img_dir = os.path.join(visual_root, raw_id.decode("utf-8") if isinstance(raw_id, bytes) else str(raw_id))
        save_pose_comparison(imgs[bi], host["estimated_poses"][bi], batch["poses_gt"][bi], batch["cuboid3d"][bi],
                             batch["keypoints3d"][bi], batch["camera"][bi], batch["offsets"][bi], path_out=img_dir,
                             add_correct=pose_stats[1], draw_reprojection=True)
        save_proxy_error_maps(host["proxy_dist"][bi], tseg[bi], img_dir, no_features=opt.no_points)
        save_mask_by_proxy_loss(host["proxy_per_object"][bi], tseg[bi], img_dir)


def run_evaluation(opt, device="cuda"):
    """The evaluation driver; returns the summary metrics dict of the JAX harness."""
    from casapose_tpu_torch.data.ndds import VectorfieldDataset
    from casapose_tpu_torch.utils.io import write_poses

    _check_ported(opt)
    dev = resolve_device(device)
    os.makedirs(opt.evalf, exist_ok=True)
    objectsofinterest = [x.strip() for x in opt.object.split(",")]
    no_objects = len(objectsofinterest)

    use_split = opt.data == opt.datatest  # same folder: evaluate the held-out split
    if use_split:
        print(f"split datasets with ratio {opt.train_validation_split}")
    test_dataset = VectorfieldDataset(
        root=opt.datatest, path_meshes=opt.datameshes, path_filter_root=opt.datatest_path_filter,
        color_input=opt.color_dataset, no_points=opt.no_points, objectsofinterest=objectsofinterest, noise=0.00001,
        random_translation=(0, 0), random_rotation=0, random_crop=False, use_validation_split=use_split,
        train_validation_split=opt.train_validation_split, separated_vectorfields=opt.modelname == "pvnet",
        wxyz_quaterion_input=opt.datatest_wxyz_quaterion,
        # Off unless --cache_records 1, as in the JAX harness: one pass over a test split gains nothing from it.
        record_cache_dir=os.path.join(opt.outf, "record_cache", "eval") if getattr(opt, "cache_records", None) else None,
    )
    B = max(int(getattr(opt, "batchsize_test", 1)), 1)
    testingdata, test_batches = test_dataset.generate_dataset(
        B, 1, opt.prefetch, opt.imagesize_test, 1.0, opt.workers, no_objects, shuffle=False, seed=opt.manualseed,
        drop_remainder=False,
    )
    mesh_vertex_array, mesh_vertex_count = test_dataset.generate_object_vertex_array()

    model = build_model_from_opt(opt, no_objects, device=dev,
                                 generator=torch.Generator().manual_seed(int(opt.manualseed)))
    load_weights_from_opt(opt, model)
    step = build_test_step(model, opt, no_objects, mesh_vertex_array, mesh_vertex_count, loss_weights_from_opt(opt))

    with open(os.path.join(opt.evalf, "loss_test_eval.csv"), "w") as f:
        f.write("batchid,loss,mask_loss,vertex_loss,proxy_loss,kp_loss,mask_loss_weight,vertex_loss_weight,"
                "proxy_loss_weight,kp_loss_weight\n")
    with open(os.path.join(opt.evalf, "test_summary_eval.csv"), "w") as f:
        f.write("loss,mask_loss,vertex_loss,proxy_loss,kp_loss,time" + "".join(f",2d_{o}" for o in objectsofinterest)
                + ",2d_mean" + "".join(f",3d_{o}" for o in objectsofinterest) + ",3d_mean\n")
    for f in sorted(glob.glob(os.path.join(opt.evalf, "poses_out", "*", "*.txt"))):
        os.remove(f)

    test_loss = np.zeros(5)
    total_images = 0
    sums = {key: np.zeros(no_objects) for key in ("v2d", "v3d", "gt", "fp", "e2d", "e3d", "missed")}
    times = []
    phase = {"fetch": 0.0, "h2d": 0.0, "step": 0.0, "host_io": 0.0}
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    wall0 = mark = time.time()
    first_done, first_images = None, 0
    print(f"Test Batches: {test_batches}")
    # --profile_dir: batches 1-5, as the JAX harness traces (batch 0 is its compile batch)
    profiler = ProfileWindow(getattr(opt, "profile_dir", None), 1, 6, dev, "eval_trace")
    try:
        for batch_idx in range(int(test_batches)):
            profiler.before(batch_idx)
            t0 = time.time()
            batch = testingdata.get_next()
            t1 = time.time()
            dev_batch = {key: torch.as_tensor(v, device=dev) for key, v in batch.items() if key != "image_id"}
            t2 = time.time()
            out = step(dev_batch)
            sync()
            now = time.time()
            phase["fetch"] += t1 - t0
            phase["h2d"] += t2 - t1
            phase["step"] += now - t2
            dt = now - mark  # block-to-block wall per batch, as the JAX harness's time column
            mark = now
            times.append(dt)

            b_actual = batch["img"].shape[0]
            losses = out["losses"].cpu().numpy()
            ps = [x.cpu().numpy() for x in out["pose_stats"]]
            test_loss += losses * b_actual
            total_images += b_actual
            for key, i in (("v2d", 0), ("v3d", 1), ("gt", 2), ("fp", 7), ("e2d", 4), ("e3d", 5), ("missed", 6)):
                sums[key] += ps[i]
            with open(os.path.join(opt.evalf, "loss_test_eval.csv"), "a") as f:
                # 7 values under the 10-column header: the reference's format (its 7th value is the time)
                f.write("{},{:.15f},{:.7f},{:.7f},{:.7f},{:.7f},{:.7f}\n".format(batch_idx + 1, *losses, dt))
            if (batch_idx + 1) % max(opt.loginterval, 1) == 0:
                print(f"Batch idx: {batch_idx}, Loss: {losses[0]:.5f} --- mask: {losses[1]:.5f}, vector: {losses[2]:.5f}, "
                      f"proxy: {losses[3]:.5f}, kp: {losses[4]:.5f} -- Average Loss: {test_loss[0] / max(total_images, 1):.5f}")
                print(f"Test Sum GT: {sums['gt']}")
                print(f"Test Sum 2D: {sums['v2d']}")
                print(f"Test Sum 3D: {sums['v3d']}")
            if opt.write_poses:
                est = out["estimated_poses"].cpu().numpy()
                for bi in range(b_actual):
                    write_poses(batch["poses_gt"][bi], est[bi], objectsofinterest, batch["image_id"][bi],
                                os.path.join(opt.evalf, "poses_out") + "/", time_needed=dt / b_actual)
            if opt.save_eval_batches:
                _save_eval_visuals(opt, batch, out, ps, no_objects, batch_idx)
            phase["host_io"] += time.time() - now
            if first_done is None:
                first_done, first_images = time.time(), b_actual
        loop_end = time.time()
        profiler.close()  # fewer than 7 batches: stop at the loop's end
    finally:
        testingdata.close()

    test_loss /= max(total_images, 1)
    with np.errstate(divide="ignore", invalid="ignore"):
        err_2d = np.nan_to_num(sums["v2d"] / sums["gt"])
        err_3d = np.nan_to_num(sums["v3d"] / sums["gt"])
        detection_count = np.where(sums["gt"] == 0, 0.0, sums["gt"] - sums["missed"] + sums["fp"])
        precision = np.nan_to_num(np.where(detection_count > 0, sums["v3d"] / np.maximum(detection_count, 1e-9), 0.0))
    if len(times) > 10:
        mean_time = float(np.mean(times[10:]))
    elif len(times) > 1:
        mean_time = float(np.mean(times[1:]))
    else:
        mean_time = float(times[0]) if times else 0.0

    print("==========================")
    print(f"== TEST == Finished test with total loss: {test_loss[0]:.7f} --- mask: {test_loss[1]:.7f}, "
          f"vector: {test_loss[2]:.7f}, proxy: {test_loss[3]:.7f}, kp: {test_loss[4]:.7f} ==")
    print(f"2D Valid: {err_2d}")
    print(f"2D Valid (mean): {err_2d.mean()}")
    print(f"3D Valid: {err_3d}")
    print(f"3D Valid (mean): {err_3d.mean()}")
    print(f"3D Valid (precision): {precision}")
    print(f"3D Valid (average precision): {precision.mean()}")
    print("==========================")
    with open(os.path.join(opt.evalf, "test_summary_eval.csv"), "a") as f:
        f.write("{:.7f},{:.7f},{:.7f},{:.7f},{:.7f},{:.5f}".format(*test_loss, mean_time)
                + "".join(f",{e:.4f}" for e in err_2d) + f",{err_2d.mean():.4f}"
                + "".join(f",{e:.4f}" for e in err_3d) + f",{err_3d.mean():.4f}\n")

    wall = time.time() - wall0
    steady_img_per_sec = 0.0
    if total_images:
        shares = ", ".join(f"{key} {v:.1f}s ({100 * v / max(wall, 1e-9):.0f}%)" for key, v in phase.items())
        print(f"harness wall {wall:.1f}s for {total_images} images ({total_images / max(wall, 1e-9):.1f} img/s "
              f"end-to-end) on {dev}: {shares}")
        if first_done is not None and total_images > first_images:
            steady_img_per_sec = (total_images - first_images) / max(loop_end - first_done, 1e-9)
            print(f"steady-state {steady_img_per_sec:.1f} img/s over {total_images - first_images} images")
    return {
        "loss": test_loss, "err_2d": err_2d, "err_3d": err_3d, "precision": precision, "mean_time": mean_time,
        "wall_seconds": wall, "total_images": total_images, "phase_seconds": phase,
        "steady_img_per_sec": steady_img_per_sec,
    }


def main(argv=None):
    """``python -m casapose_tpu_torch.eval``: the flags of ``test_casapose.py``, plus ``--device``."""
    from casapose_tpu_torch.utils.config import parse_config

    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args, rest = pre.parse_known_args(argv)
    run_evaluation(parse_config(rest), device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
