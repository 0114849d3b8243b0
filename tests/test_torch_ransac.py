"""The port's RANSAC voting against casapose_tpu's, on the CPU.

The JAX package draws its candidate noise and hypothesis indices with
threefry, which no torch generator reproduces. So the parity test rebuilds
JAX's own draws with ``jax.random`` from the same key, in the order the JAX
function splits it, and hands them to the port through ``draws=``. With the
same draws both run the same arithmetic, and the voted points agree to 1e-3
px, except where an inlier test lands within float32 rounding of the 0.99
cosine threshold: there one package may count a candidate that the other
does not, and a different hypothesis can win. The test finds such
(pair, keypoint) cases by recomputing the cosines in float64, reports their
number, and requires every other point to agree; the tolerance is not
widened for them. The four scenarios of tests/test_ransac.py then run on the
port alone, with a ``torch.Generator``.
"""

import numpy as np
import pytest

from tests.test_ransac import _make_field
from tests.torch_parity import jax_ransac_draws


def _scene(b=2, h=40, w=48, seed=0):
    """Two objects per image as blobs with noisy fields to 3 keypoints each; object 2 of image 2 has 3 px."""
    rng = np.random.default_rng(seed)
    oc, vn = 2, 3
    mask = np.zeros((b, h, w, oc), np.float32)
    field = np.zeros((b, h, w, vn, 2), np.float32)
    for i in range(b):
        for o in range(oc):
            m = np.zeros((h, w), bool)
            if i == 1 and o == 1:
                m[30, 40:43] = True  # fewer than min_num pixels: zeros
            else:
                y0, x0 = rng.integers(2, h // 2), rng.integers(2, w // 2)
                m[y0 : y0 + rng.integers(10, h // 2), x0 : x0 + rng.integers(10, w // 2)] = True
            m &= mask[i].sum(-1) == 0
            mask[i, :, :, o] = m
            kps = rng.uniform(0, min(h, w), (vn, 2))
            f = _make_field(h, w, m, [tuple(k) for k in kps])
            noisy = f + rng.normal(scale=0.15, size=f.shape).astype(np.float32) * m[..., None, None]
            field[i] = np.where(m[..., None, None], noisy, field[i])
    return mask, field


def _near_threshold(mask, field, pair, kp, points, thresh=0.99, band=1e-6):
    """Whether any foreground pixel of ``pair`` tests within float32 rounding of the cosine threshold against one of
    ``points`` (the two packages' winners), in float64."""
    i, o = pair
    h, w = mask.shape[1:3]
    flat = mask[i, :, :, o].reshape(-1)
    cy, cx = np.divmod(np.nonzero(flat)[0], w)  # every foreground pixel: a superset of the candidate set
    d = field[i].reshape(h * w, -1, 2)[flat > 0][:, kp, ::-1].astype(np.float64)
    for p in points:
        hvec = np.asarray(p, np.float64)[None] - np.stack([cx + 0.5, cy + 0.5], 1)
        cos = (d * hvec).sum(1) / (np.linalg.norm(d, axis=1) * np.linalg.norm(hvec, axis=1) + 1e-30)
        if np.any(np.abs(cos - thresh) < band):
            return True
    return False


@pytest.mark.parametrize("max_num, rounds, hyp", [(30000, 3, 512), (150, 2, 128)])
def test_ransac_matches_jax_with_its_draws(max_num, rounds, hyp):
    """max_num 30000: every foreground pixel is a candidate; 150: the blobs are downsampled by the noisy top-k."""
    import jax
    import jax.numpy as jnp
    import torch

    from casapose_tpu.pose.ransac import ransac_voting_layer_all_masks as jax_ransac

    from casapose_tpu_torch.pose.ransac import ransac_voting_layer_all_masks

    mask, field = _scene()
    want = np.asarray(jax_ransac(jnp.asarray(mask), jnp.asarray(field), hyp, max_iter=rounds, max_num=max_num,
                                 rng_key=jax.random.PRNGKey(0)))
    draws = jax_ransac_draws(mask, 3, rounds, hyp, max_num)
    got = ransac_voting_layer_all_masks(torch.from_numpy(mask), torch.from_numpy(field), hyp, max_iter=rounds,
                                        max_num=max_num, draws=draws).numpy()
    assert got.shape == want.shape == (2, 2, 3, 2)
    np.testing.assert_array_equal(got[1, 1], 0.0)  # 3 px < min_num
    off = np.abs(got - want).max(-1) > 1e-3
    near = [(i, o, k) for i, o, k in zip(*np.nonzero(off))
            if _near_threshold(mask, field, (i, o), k, [got[i, o, k], want[i, o, k]])]
    print(f"{len(near)} of {off.size} voted points differ where an inlier test is within float32 rounding of 0.99")
    far = [tuple(int(v) for v in c) for c in zip(*np.nonzero(off)) if tuple(c) not in set(near)]
    assert not far, f"points differ away from the threshold: {far}, {got[off]} vs {want[off]}"
    assert np.abs(got[0] - want[0]).max() < 50.0  # a sanity bound on the scene's scale


# ----------------------------------------------------------------- tests/test_ransac.py's scenarios on the port


def _port(masks, field, hyp, seed, **kw):
    import torch

    from casapose_tpu_torch.pose.ransac import ransac_voting_layer_all_masks

    return ransac_voting_layer_all_masks(torch.from_numpy(np.ascontiguousarray(masks)),
                                         torch.from_numpy(np.ascontiguousarray(field)), hyp,
                                         generator=torch.Generator().manual_seed(seed), **kw).numpy()


def test_ransac_recovers_keypoints():
    h, w = 64, 64
    mask = np.zeros((h, w), bool)
    mask[10:40, 15:50] = True
    kps = [(20.0, 30.0), (5.0, 55.0), (50.0, 10.0)]
    pts = _port(mask[None, :, :, None].astype(np.float32), _make_field(h, w, mask, kps)[None], 128, 0, max_num=2048)
    for ki, (ky, kx) in enumerate(kps):
        np.testing.assert_allclose(pts[0, 0, ki], [kx, ky], atol=0.5)


def test_ransac_with_outliers():
    h, w = 64, 64
    rng = np.random.default_rng(0)
    mask = np.zeros((h, w), bool)
    mask[8:56, 8:56] = True
    kps = [(30.0, 30.0), (12.0, 40.0)]
    field = _make_field(h, w, mask, kps)
    corrupt = (rng.uniform(size=(h, w)) < 0.2) & mask
    noise = rng.normal(size=(h, w, len(kps), 2)).astype(np.float32)
    noise /= np.linalg.norm(noise, axis=-1, keepdims=True) + 1e-9
    field = np.where(corrupt[..., None, None], noise, field)
    pts = _port(mask[None, :, :, None].astype(np.float32), field[None], 256, 1, max_num=4096)
    for ki, (ky, kx) in enumerate(kps):
        np.testing.assert_allclose(pts[0, 0, ki], [kx, ky], atol=1.5)


def test_ransac_empty_mask_returns_zero():
    h, w = 32, 32
    masks = np.zeros((1, h, w, 2), np.float32)
    masks[0, 10:20, 10:20, 0] = 1.0
    field = _make_field(h, w, masks[0, :, :, 0] > 0, [(15.0, 15.0)])
    pts = _port(masks, field[None], 64, 2, max_num=1024)
    np.testing.assert_allclose(pts[0, 1], 0.0, atol=1e-6)
    np.testing.assert_allclose(pts[0, 0, 0], [15.0, 15.0], atol=0.5)


def test_ransac_adaptive_confidence_gating():
    """On a clean field round 1 clears the confidence, so more rounds change nothing; with confidence 1.0 every
    round counts and the result is at least as accurate."""
    h, w = 64, 64
    mask = np.zeros((h, w), bool)
    mask[10:40, 15:50] = True
    kps = [(20.0, 30.0), (5.0, 55.0)]
    masks, field = mask[None, :, :, None].astype(np.float32), _make_field(h, w, mask, kps)[None]
    one = _port(masks, field, 128, 3, max_iter=1, max_num=2048)
    gated = _port(masks, field, 128, 3, max_iter=8, max_num=2048)
    np.testing.assert_allclose(gated, one, atol=1e-4)
    ungated = _port(masks, field, 128, 3, max_iter=8, max_num=2048, confidence=1.0)
    truth = np.asarray([[30.0, 20.0], [55.0, 5.0]])
    assert np.abs(ungated[0, 0] - truth).max() <= np.abs(one[0, 0] - truth).max() + 0.25


def test_ransac_chunking_does_not_change_the_result():
    """Pairs and hypotheses in chunks of any size (here one pair and 34 hypotheses at a time) draw the same
    hypotheses and pick the same winners; only the refinement's float32 sums may run in another order (1e-3 px, the
    parity tolerance)."""
    import torch

    from casapose_tpu_torch.pose.ransac import ransac_voting_layer_all_masks

    mask, field = (torch.from_numpy(a) for a in _scene(seed=1))
    runs = [ransac_voting_layer_all_masks(mask, field, 128, max_iter=2, generator=torch.Generator().manual_seed(5),
                                          **kw) for kw in ({}, {"chunk_elements": 200000})]
    torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=1e-3)
