"""Software z-buffer rasterizer for offline mask rendering (numpy only).

A copy of ``casapose_tpu/data/raster.py``, for the "render" mask mode of
``python -m casapose_tpu_torch.dataset_converter``: the reference renders a
per-object depth map with pyrender/OpenGL and takes the per-pixel argmin
over the stacked depths to build an integer-id segmentation mask
(util_scripts/dataset_converter.py:64-96). It never runs on the device path.

Conventions (the reference's CV camera: x right, y down, z forward):
  * projection  u = fx * x / z + cx,  v = fy * y / z + cy  (pixel units)
  * pixel (row i, col j) is sampled at its center (j + 0.5, i + 0.5), the
    OpenGL fragment rule;
  * depth is the camera-frame z of the surface, perspective-correctly
    interpolated (1/z is linear in screen space);
  * triangles with any vertex closer than ``near`` are discarded (no
    partial near-plane clipping); fragments beyond ``far`` are dropped.

Triangles are rasterized in bbox-size groups so the inner loops are
vectorized numpy over [chunk, G, G] sample grids instead of a Python loop
per pixel.
"""

import numpy as np

_EMPTY = np.inf
# bbox-size buckets; triangles whose bbox exceeds the largest bucket are
# rasterized one at a time with an exact-size grid.
_GROUP_SIZES = (4, 8, 16, 32, 64, 128, 256, 512)
_CHUNK_SAMPLES = 4 << 20  # cap chunk * G * G working-set elements


def render_depth(vertices, faces, K, R, t, width, height, near=100.0, far=2000.0, zbuf=None):
    """Depth map [height, width] float64; ``inf`` where nothing was hit.

    vertices [N, 3] model frame, faces [M, 3] int, K [3, 3], R [3, 3],
    t [3].  When ``zbuf`` is given, rasterizes into it in place (shared
    z-buffer across objects) and returns it.
    """
    if zbuf is None:
        zbuf = np.full((height, width), _EMPTY, np.float64)
    if len(faces) == 0 or len(vertices) == 0:
        return zbuf

    cam = np.asarray(vertices, np.float64) @ np.asarray(R, np.float64).T + np.asarray(t, np.float64).reshape(3)
    z = cam[:, 2]
    u = K[0, 0] * cam[:, 0] / np.where(z > 0, z, 1.0) + K[0, 2]
    v = K[1, 1] * cam[:, 1] / np.where(z > 0, z, 1.0) + K[1, 2]

    tu, tv, tz = u[faces], v[faces], z[faces]  # [M, 3]
    keep = np.all(tz >= near, axis=1)

    # Signed doubled area of the projected triangle; degenerate -> skip.
    area = (tu[:, 1] - tu[:, 0]) * (tv[:, 2] - tv[:, 0]) - (tv[:, 1] - tv[:, 0]) * (tu[:, 2] - tu[:, 0])
    keep &= np.abs(area) > 1e-12

    # Pixel-center bbox: sample x = j + 0.5 inside [min_u, max_u].
    j0 = np.maximum(np.ceil(tu.min(axis=1) - 0.5), 0).astype(np.int64)
    j1 = np.minimum(np.floor(tu.max(axis=1) - 0.5), width - 1).astype(np.int64)
    i0 = np.maximum(np.ceil(tv.min(axis=1) - 0.5), 0).astype(np.int64)
    i1 = np.minimum(np.floor(tv.max(axis=1) - 0.5), height - 1).astype(np.int64)
    keep &= (j1 >= j0) & (i1 >= i0)

    idx = np.nonzero(keep)[0]
    if idx.size == 0:
        return zbuf
    tu, tv, tz, area = tu[idx], tv[idx], tz[idx], area[idx]
    j0, j1, i0, i1 = j0[idx], j1[idx], i0[idx], i1[idx]
    extent = np.maximum(j1 - j0, i1 - i0) + 1

    flat = zbuf.reshape(-1)
    bounds = (0,) + _GROUP_SIZES  # extent >= 1 always; bucket 0 takes 1..4
    for g, G in enumerate(_GROUP_SIZES):
        sel = np.nonzero((extent > bounds[g]) & (extent <= G))[0]
        chunk = max(_CHUNK_SAMPLES // (G * G), 1)
        for s in range(0, sel.size, chunk):
            sub = sel[s : s + chunk]
            _raster_group(flat, tu[sub], tv[sub], tz[sub], area[sub], j0[sub], j1[sub], i0[sub], i1[sub],
                          G, width, far)
    big = np.nonzero(extent > _GROUP_SIZES[-1])[0]
    for m in big:
        G = int(extent[m])
        _raster_group(flat, tu[m : m + 1], tv[m : m + 1], tz[m : m + 1], area[m : m + 1],
                      j0[m : m + 1], j1[m : m + 1], i0[m : m + 1], i1[m : m + 1], G, width, far)
    return zbuf


def _raster_group(flat_zbuf, tu, tv, tz, area, j0, j1, i0, i1, G, width, far):
    """Rasterize a [T] triangle batch onto shared [T, G, G] sample grids."""
    # Sample coordinates: (j + 0.5, i + 0.5) for j in [j0, j0+G).
    px = (j0[:, None] + np.arange(G)[None, :])[:, None, :] + 0.5  # [T, 1, G]
    py = (i0[:, None] + np.arange(G)[None, :])[:, :, None] + 0.5  # [T, G, 1]

    x0, x1, x2 = tu[:, 0, None, None], tu[:, 1, None, None], tu[:, 2, None, None]
    y0, y1, y2 = tv[:, 0, None, None], tv[:, 1, None, None], tv[:, 2, None, None]
    # Edge functions, w_k opposite vertex k; w0+w1+w2 == area.
    w0 = (x2 - x1) * (py - y1) - (y2 - y1) * (px - x1)
    w1 = (x0 - x2) * (py - y2) - (y0 - y2) * (px - x2)
    w2 = (x1 - x0) * (py - y0) - (y1 - y0) * (px - x0)

    a = area[:, None, None]
    inside = ((w0 >= 0) & (w1 >= 0) & (w2 >= 0)) | ((w0 <= 0) & (w1 <= 0) & (w2 <= 0))
    # Grid cells may run past the clipped bbox (shared G per group).
    jj = j0[:, None, None] + np.arange(G)[None, None, :]
    ii = i0[:, None, None] + np.arange(G)[None, :, None]
    inside &= (jj <= j1[:, None, None]) & (ii <= i1[:, None, None])

    inv_z = (w0 / a) / tz[:, 0, None, None] + (w1 / a) / tz[:, 1, None, None] + (w2 / a) / tz[:, 2, None, None]
    with np.errstate(divide="ignore"):
        depth = 1.0 / inv_z
    inside &= (inv_z > 0) & (depth <= far)

    hit = np.nonzero(inside)
    if hit[0].size == 0:
        return
    lin = ii[hit[0], hit[1], 0] * width + jj[hit[0], 0, hit[2]]
    np.minimum.at(flat_zbuf, lin, depth[hit])


def render_id_mask(meshes, poses, ids, K, width, height, near=100.0, far=2000.0):
    """Integer-id mask [height, width] uint8: nearest object wins, 0 = none.

    Equivalent to the reference's stacked-depth argmin over per-object
    pyrender renders (dataset_converter.py:71-96) but with one shared
    z-buffer per object layer.  ``meshes`` is a list of (vertices, faces),
    ``poses`` of (R, t), ``ids`` the segmentation ids to write.
    """
    depths = np.full((len(meshes) + 1, height, width), _EMPTY, np.float64)
    for k, ((verts, faces), (R, t)) in enumerate(zip(meshes, poses)):
        render_depth(verts, faces, K, R, t, width, height, near, far, zbuf=depths[k + 1])
    nearest = np.argmin(depths, axis=0)
    lut = np.zeros(len(meshes) + 1, np.uint8)
    lut[1:] = np.asarray(ids, np.uint8)
    mask = lut[nearest]
    mask[~np.isfinite(depths.min(axis=0))] = 0
    return mask
