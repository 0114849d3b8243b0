"""Batched affine / projective image warp on the device: counterpart of ``casapose_tpu/ops/warp.py``.

The dst->src projective-transform semantics of ``tfa.image.transform``
(the reference's vectorfield_dataset.py:203-204), so that the geometric
augmentation could run on the device. No step calls it: the loader warps
on the host with cv2, as the JAX package's does.
"""

import torch


def affine_warp(images, transforms, interpolation="bilinear", fill_value=0.0):
    """Warp a batch of images with per-image dst->src transforms.

    Args:
      images: [b, h, w, c] float or uint8.
      transforms: [b, 8] projective transform rows [a0, a1, a2, b0, b1, b2, c0, c1]
        (tfa convention: output (x, y) samples input at
        ((a0 x + a1 y + a2) / k, (b0 x + b1 y + b2) / k), k = c0 x + c1 y + 1),
        or [b, 3, 3] matrices.
      interpolation: "bilinear" or "nearest".
    Returns: the warped images, float32 [b, h, w, c]; taps outside the image
    take ``fill_value``.
    """
    b, h, w, c = images.shape
    dtype, dev = torch.float32, images.device
    imgs = images.to(dtype)
    transforms = transforms.to(dtype)
    if transforms.shape[-1] == 8:
        t = torch.cat([transforms, torch.ones((b, 1), dtype=dtype, device=dev)], dim=1).reshape(b, 3, 3)
    else:
        t = transforms.reshape(b, 3, 3)

    ys, xs = torch.meshgrid(torch.arange(h, dtype=dtype, device=dev), torch.arange(w, dtype=dtype, device=dev),
                            indexing="ij")
    dst = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1).reshape(-1, 3)  # [P, 3] (x, y, 1)
    src = torch.einsum("bij,pj->bpi", t, dst)  # [b, P, 3]
    k = torch.where(src[..., 2:] == 0, torch.ones_like(src[..., 2:]), src[..., 2:])
    sx = src[..., 0] / k[..., 0]
    sy = src[..., 1] / k[..., 0]
    flat = imgs.reshape(b, h * w, c)

    def sample(ix, iy):
        # Out-of-range taps contribute the fill value (the cv2 / tfa border convention), not an edge-clamped sample.
        valid = (ix >= 0) & (ix <= w - 1) & (iy >= 0) & (iy <= h - 1)
        idx = (torch.clamp(iy, 0, h - 1) * w + torch.clamp(ix, 0, w - 1)).to(torch.int64)
        tap = torch.gather(flat, 1, idx[..., None].expand(b, idx.shape[1], c))
        return torch.where(valid[..., None], tap, torch.full_like(tap, fill_value))

    inside = (sx > -1) & (sx < w) & (sy > -1) & (sy < h)
    if interpolation == "nearest":
        out = sample(torch.round(sx), torch.round(sy))
    else:
        x0, y0 = torch.floor(sx), torch.floor(sy)
        fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
        out = (sample(x0, y0) * (1 - fx) * (1 - fy) + sample(x0 + 1, y0) * fx * (1 - fy)
               + sample(x0, y0 + 1) * (1 - fx) * fy + sample(x0 + 1, y0 + 1) * fx * fy)
    out = torch.where(inside[..., None], out, torch.full_like(out, fill_value))
    return out.reshape(b, h, w, c)
