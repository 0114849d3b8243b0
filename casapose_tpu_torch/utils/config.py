"""Two-tier config: INI file defaults + CLI overrides.

A copy of ``casapose_tpu/utils/config.py`` (the port imports nothing of the
JAX package): the same flags, defaults and post-processing, so the shipped
``configs/config_8.ini`` / ``config_13.ini`` parse the same. Some flags name
features of the JAX package that the port has not ported yet; the port's
entry points raise where such a flag would change the result.
"""

import argparse
import configparser

import numpy as np


def str2bool(v):
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


def build_parser():
    # fmt: off
    parser = argparse.ArgumentParser()
    parser.add_argument("--data", default="", help="path to training data")
    parser.add_argument("--data_path_filter", default=None, help="a list of allowed direct subfolders for the data folder")
    parser.add_argument("--datatest", default="", help="path to data testing/validation set")
    parser.add_argument("--datatest_path_filter", default=None, help="a list of allowed direct subfolders for the datatest folder")
    parser.add_argument("--color_dataset", type=str2bool, default=True, help="is true if dataset is rgb")
    parser.add_argument("--data_wxyz_quaterion", type=str2bool, default=False, help="data has wxyz quaternion format")
    parser.add_argument("--datatest_wxyz_quaterion", type=str2bool, default=False, help="datatest has wxyz quaternion format")

    parser.add_argument("--datameshes", default="", help="path to meshes from dataset")
    parser.add_argument("--modelname", default="casapose_cond_weighted", help="name of the model to use")
    parser.add_argument("--backbonename", default="resnet18", help="name of the backbone to use")
    parser.add_argument("--train_validation_split", type=float, default=0.9, help="train validation split")
    parser.add_argument("--estimate_confidence", type=str2bool, default=False, help="network estimates confidence map (adds no_points output maps)")
    parser.add_argument("--estimate_coords", type=str2bool, default=False, help="network estimates coords via reprojection and bpnp")
    parser.add_argument("--confidence_regularization", type=str2bool, default=False, help="loss regularization so the estimates do not get too small")
    parser.add_argument("--confidence_filter_estimates", type=str2bool, default=True, help="apply connected component analysis and choose largest")
    parser.add_argument(
        "--profile_dir", default=None,
        help="write a torch.profiler trace (CPU and CUDA activity, a Chrome trace <dir>/train_trace.json "
        "or eval_trace.json) covering steps 10-15 of the first training epoch or eval batches 1-5",
    )
    parser.add_argument(
        "--ransac_rounds", type=int, default=20,
        help="max hypothesis rounds (512 each) for RANSAC keypoint voting on the estimate_coords=0 "
        "path; rounds after the adaptive confidence threshold stop contributing (reference "
        "ransac_voting.py:318-347 semantics, default max_iter 20)",
    )
    parser.add_argument(
        "--cc_filter_downsample", type=int, default=4,
        help="resolution divisor for the connected-component instance filter (1 = exact full-resolution "
        "labeling, matching tfa.image.connected_components; 4 = OR-pooled quarter resolution, ~16x cheaper)",
    )
    parser.add_argument("--confidence_choose_second", type=str2bool, default=False, help="choose second largest component during testing")

    parser.add_argument("--mask_loss_weight", type=float, default=1.0, help="mask loss weight")
    parser.add_argument("--vertex_loss_weight", type=float, default=0.5, help="vertex loss weight")
    parser.add_argument("--proxy_loss_weight", type=float, default=0.013, help="proxy loss weight")
    parser.add_argument("--keypoint_loss_weight", type=float, default=0.0, help="keypoint loss weight")
    parser.add_argument("--filter_vertex_with_segmentation", type=str2bool, default=False, help="only calculate proxy and vertex error where segmentation was estimated correctly")
    parser.add_argument("--filter_high_proxy_errors", type=str2bool, default=False, help="ignore objects with high proxy error in training")
    parser.add_argument("--use_bpnp_reprojection_loss", type=str2bool, default=False, help="calculate error on reprojected points")
    parser.add_argument("--max_keypoint_pixel_error", type=float, default=25.0, help="reprojection errors above this are downweighted")

    parser.add_argument("--object", default=None, help="which object in the dataset is of interest")
    parser.add_argument(
        "--custom_decoder_params", default=None,
        help="casapose_custom per-layer decoder wiring: 5 comma-separated 5-bit groups "
        "'wc pc gu bu rc' (weighted CLADE, partial conv, guided ups, bilinear ups, reuse conv); "
        "e.g. the gcu5 wiring is 11000,11100,11100,11100,11000",
    )
    parser.add_argument("--no_points", type=int, default=9, help="number of keypoints to find")

    parser.add_argument("--workers", type=int, default=1, help="number of data loading workers")
    parser.add_argument("--prefetch", type=int, default=0, help="size of prefetch buffer")
    parser.add_argument("--pretrained", type=str2bool, default=True, help="use imagenet pretrained backbone weights when available")
    parser.add_argument(
        "--compute_dtype",
        default="float32",
        choices=["float32", "bfloat16"],
        help="network compute dtype (params, optimizer and losses stay float32). bfloat16 roughly "
        "halves training step time on TPU; float32 matches the TF reference bit-for-bit.",
    )
    parser.add_argument(
        "--remat",
        type=str2bool,
        default=False,
        help="rematerialize the network forward in the backward pass (torch.utils.checkpoint): lower peak "
        "device memory (larger per-card batches) for ~1 extra forward of recompute",
    )
    parser.add_argument(
        "--batchsize_test",
        type=int,
        default=1,
        help="evaluation batch size. The reference harness is structurally batch-1 "
        "(test_casapose.py:155-184); batching the jit eval step is the TPU-first throughput win. "
        "Metrics are identical to batch-1 (summary counters are image sums; the loss average is "
        "image-weighted; a partial tail batch runs at its own shape). loss_test_eval.csv gets one "
        "row per BATCH in batched mode.",
    )
    parser.add_argument(
        "--eval_chunk",
        type=int,
        default=0,
        help="process eval batches in sub-chunks of this size inside the jit step (lax.map): only "
        "one chunk's voting/loss intermediates are live at a time, so large --batchsize_test fits "
        "in HBM (e.g. --batchsize_test 32 --eval_chunk 8 at 480x640). 0 = off. Metrics are exact; "
        "the per-batch loss row is the mean over equal-size chunks (the same image weighting the "
        "summary accumulates).",
    )
    parser.add_argument(
        "--quantized_inference",
        type=str,
        default="",
        choices=["", "int8"],
        help="run evaluation with quantized convolutions (ops/quant.py): 'int8' computes every "
        "convolution on int8 codes (per-image activation scales, per-channel weight scales) as an "
        "s8xs8->s32 product, torch._int_mm on an im2col of the codes (cuBLASLt's int8 path on the "
        "card), then one float32 rescale. The reference is float32 end to end; accuracy bands in "
        "tests/test_quant.py.",
    )
    parser.add_argument(
        "--cache_records",
        type=str2bool,
        default=None,
        help="cache decoded dataset frames as uint8 npy under <outf>/record_cache (first epoch "
        "decodes, later epochs read ~1 MB contiguous files the OS page cache serves from RAM; "
        "entries auto-invalidate when source files change, superseded entries are pruned). "
        "TPU-first addition: keeps the host loader ahead of the accelerator. Default: on for "
        "training (multi-epoch reuse), off for single-pass evaluation.",
    )
    parser.add_argument(
        "--export_path",
        default=None,
        help="(python -m casapose_tpu_torch.export_model) output path for the torch.export program "
        "of the inference pipeline (network -> LS voting -> PnP, weights inside the artifact). A "
        "serving host loads it with core/export.py::load_exported, which needs torch and "
        "casapose_tpu_torch.ops (its custom operators).",
    )
    parser.add_argument(
        "--export_platforms",
        default="tpu",
        help="(python -m casapose_tpu_torch.export_model) comma-separated devices to export for, one "
        "program each: 'cpu' is the CPU, an accelerator name ('tpu', 'gpu', 'cuda') the card. Each "
        "program is traced on its device, so exporting for the card needs it.",
    )
    parser.add_argument(
        "--matmul_precision",
        default="highest",
        choices=["default", "high", "highest"],
        help="float32 matmul and convolution precision of the train and eval steps, as XLA's GPU backend "
        "reads the JAX flag: 'highest' (the default, the TF reference's float32) turns TF32 off in cuBLAS "
        "and cuDNN; 'high' and 'default' turn it on (tensor-core TF32, a 10-bit mantissa: faster, about "
        "three decimal digits). The pose and voting numerics stay float32 either way.",
    )
    parser.add_argument("--batchsize", type=int, default=32, help="input batch size")
    parser.add_argument("--imagesize", nargs="+", type=int, default=[448], help="height / width of the network input")
    parser.add_argument("--imagesize_test", nargs="+", type=int, default=[448], help="height / width of the network input in evaluation")

    parser.add_argument("--lr", type=float, default=0.001, help="initial learning rate")
    parser.add_argument("--lr_decay", type=float, default=1.0, help="learning rate decay")
    parser.add_argument("--lr_epochs", type=int, default=15, help="apply decay every n epochs")
    parser.add_argument("--lr_epochs_start", type=int, default=0, help="initial lr kept for n epochs, then decay starts")
    parser.add_argument("--lr_epochs_steps", default=None, help="list of epochs where the lr is decayed")
    parser.add_argument("--noise", type=float, default=0.0, help="gaussian noise added to the image")
    parser.add_argument("--contrast", type=float, default=0.4, help="contrast manipulation during training")
    parser.add_argument("--brightness", type=float, default=0.2, help="brightness manipulation during training")
    parser.add_argument("--saturation", type=float, default=0.001, help="saturation manipulation during training")
    parser.add_argument("--hue", type=float, default=0.001, help="hue manipulation during training")
    parser.add_argument("--use_imgaug", type=str2bool, default=False, help="use the advanced photometric augmentation pipeline")
    parser.add_argument("--rotation", type=float, default=15, help="rotation manipulation during training")
    parser.add_argument("--translation", type=float, default=25, help="translation manipulation during training")
    parser.add_argument("--crop_factor", type=float, default=1.0, help="crop factor of input image along height")
    parser.add_argument("--epochs", type=int, default=60, help="number of epochs to train")
    parser.add_argument("--loginterval", type=int, default=100, help="logging interval")
    parser.add_argument("--saveinterval", type=int, default=10, help="interval of epochs to save")
    parser.add_argument("--validationinterval", type=int, default=1, help="interval of epochs for pose evaluation during training")
    parser.add_argument("--save_debug_batch", type=str2bool, default=False, help="save debug batch and exit (training)")
    parser.add_argument("--save_eval_batches", type=str2bool, default=False, help="save eval batches")
    parser.add_argument("--write_poses", type=str2bool, default=False, help="write poses for bop evaluation")
    parser.add_argument("--filter_test_with_gt", type=str2bool, default=False, help="do not consider objects which are not in gt")
    parser.add_argument("--min_object_size_test", type=int, default=1, help="min size of objects to be detected")

    parser.add_argument("--net", default="./output/training_checkpoints", help="path to net (to continue training)")

    parser.add_argument("--manualseed", type=int, help="manual seed")
    parser.add_argument("--outf", default="tmp", help="folder to output images and model checkpoints")
    parser.add_argument("--evalf", default="", help="folder to store eval logs")
    parser.add_argument("--gpuids", nargs="+", type=int, default=[0], help="accelerator ids to use (kept for config compatibility)")

    parser.add_argument("--train_vectors_with_ground_truth", type=str2bool, default=False, help="use ground truth segmentation for CLADE training")
    parser.add_argument("--load_h5_weights", type=str2bool, default=False, help="load h5 (or converted) weights")
    parser.add_argument("--load_h5_filename", default="result_w", help="filename of weights file (without extension)")

    parser.add_argument("--copy_weights_from_backup_network", type=str2bool, default=False, help="copy semantic segmentation and clade from an existing network to expand")
    parser.add_argument("--copy_weights_add_confidence_maps", type=str2bool, default=False, help="use old model without confidence maps and add them")
    parser.add_argument("--objects_to_copy", type=int, default=0, help="the first n objects are copied to the new network")
    parser.add_argument("--objects_in_input_network", type=int, default=0, help="number of objects in input network to copy from")
    parser.add_argument("--objects_to_copy_list", default="", help="csv file specifying which objects to copy to which index")
    # fmt: on
    return parser


def parse_config(argv=None):
    conf_parser = argparse.ArgumentParser(add_help=False)
    conf_parser.add_argument("-c", "--config", help="Specify config file", metavar="FILE")
    args, remaining_argv = conf_parser.parse_known_args(argv)

    parser = build_parser()
    defaults = {}
    if args.config:
        config = configparser.ConfigParser(allow_no_value=True, inline_comment_prefixes=None)
        config.read([args.config])
        defaults.update(dict(config.items("defaults")))
        for key in ("gpuids", "imagesize", "imagesize_test"):
            if key in defaults:
                defaults[key] = [int(t) for t in defaults[key].split(",")]
    parser.set_defaults(**defaults)
    opt = parser.parse_args(remaining_argv)

    def to_pair(v):
        return (v[0], v[0]) if len(v) == 1 else (v[0], v[1])

    opt.imagesize = to_pair(opt.imagesize)
    opt.imagesize_test = to_pair(opt.imagesize_test)

    def split_string(val):
        if val is not None:
            return [x.strip() for x in val.split(",")]
        return None

    opt.data_path_filter = split_string(opt.data_path_filter)
    opt.datatest_path_filter = split_string(opt.datatest_path_filter)

    if opt.lr_epochs_steps is not None:
        opt.lr_epochs_steps = [int(x) for x in split_string(str(opt.lr_epochs_steps))]

    if opt.objects_to_copy_list == "":
        opt.objects_to_copy = np.array(
            [range(opt.objects_to_copy + 1), range(opt.objects_to_copy + 1)], np.int32
        ).transpose()
    else:
        opt.objects_to_copy = np.array(np.genfromtxt(opt.objects_to_copy_list, delimiter=","), np.int32)
        opt.objects_to_copy = np.concatenate((np.array([[0, 0]], np.int32), opt.objects_to_copy))

    if opt.objects_in_input_network == 0:
        opt.objects_in_input_network = opt.objects_to_copy.shape[0] - 1

    if opt.pretrained in ["false", "False"]:
        opt.pretrained = False

    if opt.evalf == "":
        opt.evalf = opt.outf
    if "/" not in opt.outf:
        opt.outf = "output/{}".format(opt.outf)
    if "/" not in opt.evalf:
        opt.evalf = opt.outf + "/" + opt.evalf

    if opt.manualseed is None:
        opt.manualseed = int(np.random.randint(1, 10000))

    return opt
