"""Ground-truth keypoint direction fields, on the device.

Counterpart of ``casapose_tpu/ops/vectorfield.py``: for every foreground
pixel, the unit direction from the pixel centre to each keypoint of its
object; with several instances, those of the instance whose first keypoint
(the centre) is nearest. Keypoints arrive as (y, x), pixel centres are at
+0.5, fields are (dy, dx) pairs, background is zero.
"""

import torch

from casapose_tpu_torch.core.numerics import safe_l2_normalize


def compute_vertex_vectorfield(mask, coords, use_motion=False):
    """Per-pixel keypoint directions.

    Args:
      mask: [b, h, w, 1] integer labels (0 = background, k = object k).
      coords: [b, c, o, m, 2] keypoints (y, x): c objects, o instances, m keypoints.
      use_motion: return the raw offsets, not normalised.
    Returns:
      [b, h, w, m * 2] direction field, (dy, dx) per keypoint.
    """
    b, h, w, _ = mask.shape
    c, o, m = coords.shape[1], coords.shape[2], coords.shape[3]
    dtype = coords.dtype
    labels = mask[..., 0].to(torch.int64)
    onehot = (labels[..., None] == torch.arange(1, c + 1, device=mask.device)).to(dtype)
    coords_on_mask = torch.einsum("bhwc,bcf->bhwf", onehot, coords.reshape(b, c, o * m * 2)).reshape(b, h, w, o, m, 2)

    gy = (torch.arange(h, dtype=dtype, device=mask.device) + 0.5).view(1, h, 1).expand(b, h, w)
    gx = (torch.arange(w, dtype=dtype, device=mask.device) + 0.5).view(1, 1, w).expand(b, h, w)
    grid = torch.stack([gy, gx], dim=-1)  # [b, h, w, 2]

    if o > 1:
        centers = coords_on_mask[:, :, :, :, 0]  # [b, h, w, o, 2]
        closest = torch.argmin(torch.linalg.vector_norm(grid[:, :, :, None] - centers, dim=-1), dim=-1)
        inst_onehot = (closest[..., None] == torch.arange(o, device=mask.device)).to(dtype)
        kp = torch.einsum("bhwo,bhwomd->bhwmd", inst_onehot, coords_on_mask)
    else:
        kp = coords_on_mask[:, :, :, 0]

    dirs = (kp - grid[:, :, :, None]) * (labels != 0)[..., None, None].to(dtype)
    if not use_motion:
        dirs = safe_l2_normalize(dirs, dim=-1)
    return dirs.reshape(b, h, w, m * 2)


def get_all_vectorfields(target_seg, target_vertex, filtered_seg, separated_vectorfields):
    """GT direction fields for the batch.

    Args:
      target_seg: [b, h, w, 1 + oc] one-hot segmentation.
      target_vertex: [b, oc, ic, m, 2] GT keypoints (y, x).
      filtered_seg: [b, h, w, 1] integer label map.
      separated_vectorfields: pvnet mode, one field stack per object along channels.
    Returns:
      [b, h, w, m * 2] (or [b, h, w, oc * m * 2] in pvnet mode).
    """
    if separated_vectorfields:
        fields = [
            compute_vertex_vectorfield(target_seg[:, :, :, i + 1 : i + 2].to(torch.int32), target_vertex[:, i : i + 1])
            for i in range(target_seg.shape[3] - 1)
        ]
        return torch.cat(fields, dim=3)
    return compute_vertex_vectorfield(filtered_seg, target_vertex)
