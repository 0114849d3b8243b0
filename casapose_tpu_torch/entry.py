"""The inference step: network -> keypoint voting -> EPnP+LM poses.

Counterpart of ``__graft_entry__.py::entry`` and of the step in
``bench.py::build_inference_case``: by default ``casapose_c_gcu5`` on
resnet18 in float32, ``ls_voting(..., filter_estimates=True,
raw_output=out)`` and ``poses_pnp``; ``dtype=torch.bfloat16`` is the bench's
mixed-precision network (voting and PnP stay float32). Any CASAPose variant
and backbone of the registry runs the same way; the PVNet models vote by
RANSAC over their per-object fields instead. On the card the voting sums
and the PnP solve are the hand-written CUDA kernels.
"""

import torch

from casapose_tpu_torch.core.device import resolve_device
from casapose_tpu_torch.core.numerics import matmul_precision
from casapose_tpu_torch.models.registry import PVNET_NAMES, get_model
from casapose_tpu_torch.ops.voting import ls_voting
from casapose_tpu_torch.pose.evaluation import poses_pnp
from casapose_tpu_torch.pose.ransac import ransac_voting_layer_all_masks

FLAGSHIP = "casapose_c_gcu5"


def build_inference_step(no_objects=8, k=9, h=480, w=640, device="cuda", generator=None, modelname=FLAGSHIP,
                         base_model="resnet18", dtype=torch.float32, ransac_rounds=20, precision="highest"):
    """Build the inference step and its model.

    Args:
      no_objects, k: objects and keypoints; a CASAPose model has 1 + no_objects
        segmentation and 3k vertex channels (directions and confidences), a
        PVNet model 2k direction channels per object.
      h, w: image size the step is meant for (checked on each call).
      device: "cuda" (default) or "cpu"; CUDA raises where there is none.
      generator: ``torch.Generator`` for the random weights (default seed 0).
      modelname, base_model: a name and a backbone of the registry.
      dtype: the network's compute dtype, torch.float32 or torch.bfloat16.
      ransac_rounds: RANSAC rounds (PVNet models only).
      precision: ``--matmul_precision``: "highest" (TF32 off, the default) or
        "high" / "default" (TF32 in the network's convolutions and matmuls).
    Returns:
      (step, model); ``step(img [b, h, w, 3], keypoints3d [b, oc, 1, k, 3],
      camera [b, 3, 3]) -> poses [b, oc, 1, 3, 4]``, all float32 on
      ``device``. ``step(..., return_points=True)`` also returns the voted
      keypoints [b, oc, k, 2], (y, x).
    """
    dev = resolve_device(device)
    seg_dim = 1 + no_objects
    pvnet = modelname in PVNET_NAMES
    ver_dim = 2 * k * no_objects if pvnet else 3 * k
    model = get_model(modelname, ver_dim=ver_dim, seg_dim=seg_dim, base_model=base_model, dtype=dtype, device=dev,
                      generator=generator)

    def vote(out):
        seg = out[..., :seg_dim]
        if not pvnet:
            dirs = out[..., seg_dim : seg_dim + 2 * k]
            conf = out[..., seg_dim + 2 * k :]
            return ls_voting(seg, dirs, conf, num_points=k, filter_estimates=True, raw_output=out)
        # Each pixel votes with the field stack of its predicted class (the eval step's RANSAC branch).
        b = out.shape[0]
        labels = torch.argmax(seg, dim=-1)
        hot = (labels[..., None] == torch.arange(1, seg_dim, device=out.device)).to(out.dtype)
        fields = out[..., seg_dim:].reshape(b, h, w, no_objects, k, 2)
        pick = torch.clamp(labels - 1, min=0)[..., None, None, None].expand(b, h, w, 1, k, 2)
        fields = torch.gather(fields, 3, pick)[:, :, :, 0] * (labels > 0)[..., None, None].to(out.dtype)
        points = ransac_voting_layer_all_masks(hot, fields, 512, max_iter=ransac_rounds, min_num=20)
        return points.flip(-1)  # (x, y) -> (y, x)

    @torch.no_grad()
    def step(img, keypoints3d, camera, return_points=False):
        if tuple(img.shape[1:]) != (h, w, 3):
            raise ValueError(f"step expects images [b, {h}, {w}, 3], got {tuple(img.shape)}")
        with matmul_precision(precision):
            out = model(img)
            coords = vote(out)
            poses = poses_pnp(coords, out[..., :seg_dim], keypoints3d, camera, no_objects)
        return (poses, coords) if return_points else poses

    return step, model
