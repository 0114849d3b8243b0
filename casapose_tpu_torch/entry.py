"""The flagship inference step: network -> CC-filtered LS voting -> EPnP+LM poses.

Counterpart of ``__graft_entry__.py::entry`` and of the step in
``bench.py::build_inference_case`` (which this slice runs in float32):
``casapose_c_gcu5`` forward, ``ls_voting(..., filter_estimates=True,
raw_output=out)`` and ``poses_pnp``. On the card the voting sums and the
PnP solve are the hand-written CUDA kernels.
"""

import torch

from casapose_tpu_torch.core.device import resolve_device
from casapose_tpu_torch.core.numerics import f32_precision
from casapose_tpu_torch.models.registry import get_model
from casapose_tpu_torch.ops.voting import ls_voting
from casapose_tpu_torch.pose.evaluation import poses_pnp

FLAGSHIP = "casapose_c_gcu5"


def build_inference_step(no_objects=8, k=9, h=480, w=640, device="cuda", generator=None):
    """Build the inference step and its model.

    Args:
      no_objects, k: objects and keypoints; the model has 1 + no_objects
        segmentation and 3k vertex channels.
      h, w: image size the step is meant for (checked on each call).
      device: "cuda" (default) or "cpu"; CUDA raises where there is none.
      generator: ``torch.Generator`` for the random weights (default seed 0).
    Returns:
      (step, model); ``step(img [b, h, w, 3], keypoints3d [b, oc, 1, k, 3],
      camera [b, 3, 3]) -> poses [b, oc, 1, 3, 4]``, all float32 on
      ``device``. ``step(..., return_points=True)`` also returns the voted
      keypoints [b, oc, k, 2].
    """
    dev = resolve_device(device)
    seg_dim = 1 + no_objects
    model = get_model(FLAGSHIP, ver_dim=3 * k, seg_dim=seg_dim, device=dev, generator=generator)

    @torch.no_grad()
    def step(img, keypoints3d, camera, return_points=False):
        if tuple(img.shape[1:]) != (h, w, 3):
            raise ValueError(f"step expects images [b, {h}, {w}, 3], got {tuple(img.shape)}")
        with f32_precision():
            out = model(img)
            seg = out[..., :seg_dim]
            dirs = out[..., seg_dim : seg_dim + 2 * k]
            conf = out[..., seg_dim + 2 * k :]
            coords = ls_voting(seg, dirs, conf, num_points=k, filter_estimates=True, raw_output=out)
            poses = poses_pnp(coords, seg, keypoints3d, camera, no_objects)
        return (poses, coords) if return_points else poses

    return step, model
