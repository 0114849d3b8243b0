"""RANSAC keypoint voting, batched over (image, class) with static shapes.

Counterpart of ``casapose_tpu/pose/ransac.py`` (PVNet-style hypothesis
voting, the ``estimate_coords 0`` branch). Per (image, class) pair:

  * a fixed-size candidate set of ``min(max_num, h*w)`` pixels, foreground
    first, chosen by a noisy top-k (a stable sort, so equal scores keep the
    lower index first, as ``lax.top_k`` does);
  * ``max_iter`` rounds of ``round_hyp_num`` hypotheses, each the crossing
    of two candidates' direction lines, scored by their inliers (the cosine
    between a candidate's direction and the hypothesis is above
    ``inlier_thresh``), counted in chunks of hypotheses;
  * fixed-length rounds: once the RANSAC confidence 1 - (1 - q^2)^N clears
    ``confidence``, later rounds are masked out, the reference's adaptive
    exit without a host sync;
  * the inlier-weighted least-squares refinement with an invertibility
    guard, zero for pairs of fewer than ``min_num`` foreground pixels.

Everything stays on the tensors' device. The pairs are processed in chunks,
and each chunk's inlier counts in chunks of hypotheses, so that no
intermediate exceeds ``chunk_elements`` elements: the JAX package's form
holds a [b, oc, 128, n, vn, 2] float32 block at once, 276 MB per pair at
480x640.

Random draws come from a ``torch.Generator`` on the tensors' device.
``draws=`` hands in the numbers instead (the JAX package draws them with
threefry, which no torch generator reproduces): ``{"noise": [b, oc, h*w]
uniform [0, 1), "hypotheses": [b, oc, max_iter, round_hyp_num, vn, 2]
candidate indices}``.
"""

import torch

from casapose_tpu_torch.core.numerics import divide_no_nan, f32_precision


def _select_candidates(mask, noise, max_num, w):
    """Foreground-first fixed-size candidate sets.

    mask, noise: [P, h*w]. Returns (coords [P, n, 2] (x, y) + 0.5, valid [P, n], idx [P, n]).
    """
    n = min(max_num, mask.shape[1])
    scores = mask * 2.0 + noise
    idx = torch.sort(scores, dim=1, descending=True, stable=True)[1][:, :n]
    valid = torch.gather(mask, 1, idx)
    coords = torch.stack([(idx % w).to(torch.float32) + 0.5, (idx // w).to(torch.float32) + 0.5], dim=-1)
    return coords, valid, idx


def _inlier_counts(coords, direct, valid, norm_d, hyp, inlier_thresh):
    """Inliers of each hypothesis: [P, hc] x vn counts (float), or the mask [P, n, vn] for one hypothesis each.

    coords [P, n, 2], direct [P, n, vn, 2] (dx, dy), valid [P, n], norm_d [P, n, vn], hyp [P, hc, vn, 2].
    """
    dx = hyp[:, :, None, :, 0] - coords[:, None, :, None, 0]  # [P, hc, n, vn]
    dy = hyp[:, :, None, :, 1] - coords[:, None, :, None, 1]
    norm_h = torch.sqrt(dx * dx + dy * dy)
    dot = direct[:, None, :, :, 0] * dx + direct[:, None, :, :, 1] * dy
    del dx, dy
    cos = divide_no_nan(dot, norm_d[:, None] * norm_h)
    hyp_ok = torch.abs(hyp[..., 0] + hyp[..., 1]) > 1e-6  # [P, hc, vn]
    inl = (norm_d[:, None] > 1e-6) & (norm_h > 1e-6) & hyp_ok[:, :, None] & (cos > inlier_thresh)
    return inl.to(torch.float32) * valid[:, None, :, None]  # [P, hc, n, vn]


def _hypotheses(coords, direct, idxs):
    """Crossings of the direction lines of the candidate pairs ``idxs`` [P, hn, vn, 2] -> [P, hn, vn, 2] (x, y)."""
    P, hn, vn, _ = idxs.shape
    pair = torch.arange(P, device=idxs.device).view(P, 1, 1, 1)
    c_s = coords[pair, idxs]  # [P, hn, vn, 2, 2]
    d_s = direct[pair, idxs, torch.arange(vn, device=idxs.device).view(1, 1, vn, 1)]  # [P, hn, vn, 2, 2]
    det = d_s[..., 1, 0] * d_s[..., 0, 1] - d_s[..., 1, 1] * d_s[..., 0, 0]
    u = divide_no_nan(
        (c_s[..., 1, 1] - c_s[..., 0, 1]) * d_s[..., 1, 0] - (c_s[..., 1, 0] - c_s[..., 0, 0]) * d_s[..., 1, 1], det
    )
    hyp = c_s[..., 0, :] + d_s[..., 0, :] * u[..., None]
    return torch.where(torch.abs(det)[..., None] > 1e-6, hyp, torch.zeros_like(hyp))


def _ransac_pairs(mask, vertex, noise, hyp_draws, round_hyp_num, inlier_thresh, confidence, max_iter, min_num,
                  max_num, w, chunk_elements):
    """RANSAC for P pairs: mask [P, h*w], vertex [P, h*w, vn, 2] (dy, dx) -> [P, vn, 2] (x, y).

    ``hyp_draws(round, valid_n)`` gives the round's candidate indices [P, round_hyp_num, vn, 2].
    """
    P, _, vn, _ = vertex.shape
    coords, valid, idx = _select_candidates(mask, noise, max_num, w)
    n = coords.shape[1]
    fg_count = mask.sum(dim=1)
    direct = torch.gather(vertex, 1, idx[:, :, None, None].expand(P, n, vn, 2)).flip(-1)  # (dx, dy)
    direct = direct * valid[:, :, None, None]
    norm_d = torch.sqrt(direct[..., 0] * direct[..., 0] + direct[..., 1] * direct[..., 1])
    n_valid = valid.sum(dim=1)  # [P]
    valid_n = torch.clamp(n_valid.to(torch.int32), min=1)
    hc = max(1, min(round_hyp_num, chunk_elements // max(P * n * vn, 1)))

    all_ratio = torch.zeros(P, vn, device=mask.device)
    all_pts = torch.zeros(P, vn, 2, device=mask.device)
    done = torch.zeros(P, dtype=torch.bool, device=mask.device)
    for r in range(max_iter):
        hyp = _hypotheses(coords, direct, hyp_draws(r, valid_n))  # [P, hn, vn, 2]
        counts = torch.cat([_inlier_counts(coords, direct, valid, norm_d, hyp[:, i : i + hc], inlier_thresh).sum(2)
                            for i in range(0, round_hyp_num, hc)], dim=1)  # [P, hn, vn]
        win_counts, win_idx = torch.max(counts, dim=1)  # first maximum, as jnp.argmax
        win_pts = torch.gather(hyp, 1, win_idx[:, None, :, None].expand(P, 1, vn, 2))[:, 0]
        win_ratio = win_counts / torch.clamp(n_valid, min=1.0)[:, None]
        better = (all_ratio < win_ratio) & ~done[:, None]
        all_pts = torch.where(better[..., None], win_pts, all_pts)
        all_ratio = torch.where(better, win_ratio, all_ratio)
        hyp_total = float((r + 1) * round_hyp_num)
        min_ratio = all_ratio.min(dim=1).values
        done = done | ((1.0 - (1.0 - min_ratio**2.0) ** hyp_total) > confidence)

    # Inlier-weighted least squares on the lines through each inlier along its direction.
    inlier = _inlier_counts(coords, direct, valid, norm_d, all_pts[:, None], inlier_thresh)[:, 0]  # [P, n, vn]
    normal = torch.stack([direct[..., 1], -direct[..., 0]], dim=-1) * inlier[..., None]
    bvec = torch.sum(normal * coords[:, :, None, :], dim=-1)  # [P, n, vn]
    ATA = torch.einsum("pnvi,pnvj->pvij", normal, normal)
    ATb = torch.einsum("pnvi,pnv->pvi", normal, bvec)
    det = ATA[..., 0, 0] * ATA[..., 1, 1] - ATA[..., 0, 1] * ATA[..., 1, 0]
    trace = ATA[..., 0, 0] + ATA[..., 1, 1]
    ok = det > 1e-6 * torch.clamp(trace, min=1e-12) ** 2
    safe_det = torch.where(ok, det, torch.ones_like(det))
    refined = torch.stack([(ATA[..., 1, 1] * ATb[..., 0] - ATA[..., 0, 1] * ATb[..., 1]) / safe_det,
                           (-ATA[..., 1, 0] * ATb[..., 0] + ATA[..., 0, 0] * ATb[..., 1]) / safe_det], dim=-1)
    out = torch.where(ok[..., None], refined, all_pts)
    return torch.where((fg_count < min_num)[:, None, None], torch.zeros_like(out), out)


@f32_precision()
def ransac_voting_layer_all_masks(mask, vertex, round_hyp_num=512, inlier_thresh=0.99, confidence=0.99, max_iter=1,
                                  min_num=5, max_num=30000, generator=None, draws=None, chunk_elements=1 << 27):
    """Batched RANSAC voting.

    Args:
      mask: [b, h, w, oc] one-hot class masks.
      vertex: [b, h, w, vn, 2] direction fields (dy, dx).
      generator: ``torch.Generator`` on the tensors' device (default: a new one seeded 0, as the JAX package
        defaults to ``PRNGKey(0)``).
      draws: the random numbers to use instead, see the module docstring.
      chunk_elements: the largest intermediate, in elements; (image, class) pairs are processed in chunks that
        leave room for at least 64 hypotheses each.
    Returns:
      [b, oc, vn, 2] voted points, (x, y) pixels.
    """
    b, h, w, oc = mask.shape
    vn = vertex.shape[3]
    dev = mask.device
    P = b * oc
    masks = mask.permute(0, 3, 1, 2).reshape(P, h * w).to(torch.float32)
    if draws is None:
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        noise = torch.rand(P, h * w, generator=generator, device=dev)
        # Uniform draws for every pair and round up front, so that the chunking does not change them.
        hyp_u = torch.rand(P, max_iter, round_hyp_num, vn, 2, generator=generator, device=dev)
    else:
        noise = draws["noise"].reshape(P, h * w).to(device=dev, dtype=torch.float32)
        hyps = draws["hypotheses"].reshape(P, max_iter, round_hyp_num, vn, 2).to(device=dev, dtype=torch.int64)
    n = min(max_num, h * w)
    pair_chunk = max(1, chunk_elements // (n * vn * 64))
    vertex = vertex.reshape(b, h * w, vn, 2).to(torch.float32)
    out = []
    for p0 in range(0, P, pair_chunk):
        pairs = torch.arange(p0, min(P, p0 + pair_chunk), device=dev)

        def hyp_draws(r, valid_n, pairs=pairs):
            if draws is not None:
                return hyps[pairs, r]
            top = valid_n.view(-1, 1, 1, 1)
            return torch.minimum((hyp_u[pairs, r] * top).to(torch.int64), top - 1)

        out.append(_ransac_pairs(masks[pairs], vertex[pairs // oc], noise[pairs], hyp_draws, round_hyp_num,
                                 inlier_thresh, confidence, max_iter, min_num, max_num, w, chunk_elements))
    return torch.cat(out).reshape(b, oc, vn, 2)
