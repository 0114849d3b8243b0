"""The training side of the port's data path against the JAX package's, on the CPU.

* Colour jitter and noise of ``prepare_device_batch`` (train, imgaug off)
  with the JAX package's own draws for a key, rebuilt here as its
  ``prepare_device_batch`` makes them (threefry cannot be matched): images
  within atol 1e-3 on the 0..255 scale (the check is made before the
  normalisation); HSV conversions within 1e-5.
* ``augment_image`` byte for byte, colour and greyscale, for several seeds.
* The loader: ``make_dataset`` with ``use_imgaug`` and the record cache
  yields the JAX loader's batches byte for byte, from the cache as from the
  PNGs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_parity import single_torch_thread  # noqa: F401 (autouse)

JITTER = dict(hue=0.08, saturation=0.3, brightness=20.0, contrast=0.3)


def _jax_draws(key, shape, noise):
    """The values the JAX ``prepare_device_batch`` draws from ``key`` (its key splits, in its order)."""
    kj = jax.random.fold_in(key, 0)
    k1, k2, k3, k4 = jax.random.split(kj, 4)
    u = lambda k, lo, hi: torch.tensor(float(jax.random.uniform(k, (), minval=lo, maxval=hi)))  # noqa: E731
    draws = {
        "hue": u(k1, -JITTER["hue"], JITTER["hue"]),
        "saturation": u(k2, 1.0 - JITTER["saturation"], 1.0 + JITTER["saturation"]),
        "brightness": u(k3, -JITTER["brightness"], JITTER["brightness"]),
        "contrast": u(k4, 1.0 - JITTER["contrast"], 1.0 + JITTER["contrast"]),
    }
    kk = jax.random.split(key, 2)[1]
    draws["noise_std"] = torch.from_numpy(np.array(jax.random.uniform(kk, (1,), minval=0.0, maxval=noise)))
    draws["noise"] = torch.from_numpy(np.array(jax.random.normal(jax.random.fold_in(kk, 1), shape)))
    return draws


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_jitter_and_noise_with_the_jax_draws(seed):
    from casapose_tpu.data.pipeline import prepare_device_batch as jax_prepare
    from casapose_tpu_torch.data.pipeline import prepare_device_batch

    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (2, 12, 16, 3)).astype(np.uint8)
    img[0, :3] = img[0, :3, :, :1]  # grey pixels: zero chroma
    seg = rng.integers(0, 3, (2, 12, 16, 1)).astype(np.uint8)
    key = jax.random.PRNGKey(seed)
    draws = _jax_draws(key, img.shape, 0.05)
    for noise in (0.0, 0.05):
        ji, js = jax_prepare(jnp.asarray(img), jnp.asarray(seg), 3, rng_key=key, noise=noise, color_jitter=True,
                             **JITTER)
        pi, ps = prepare_device_batch(torch.from_numpy(img), torch.from_numpy(seg), 3, noise=noise, color_jitter=True,
                                      draws=draws, **JITTER)
        # atol 1e-3 on the 0..255 scale, after (x / 255 - 0.5) / 0.5
        np.testing.assert_allclose(pi.numpy(), np.asarray(ji), rtol=0, atol=1e-3 / 127.5)
        np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    if seed == 0:  # without a key or draws nothing random happens, in both
        ji, _ = jax_prepare(jnp.asarray(img), jnp.asarray(seg), 3, noise=0.05, color_jitter=True, **JITTER)
        pi, _ = prepare_device_batch(torch.from_numpy(img), torch.from_numpy(seg), 3, noise=0.05, color_jitter=True,
                                     **JITTER)
        np.testing.assert_allclose(pi.numpy(), np.asarray(ji), rtol=0, atol=1e-6)


def test_hsv_conversions():
    from casapose_tpu.data import color as jc
    from casapose_tpu_torch.data import color as pc

    rng = np.random.default_rng(3)
    img = rng.uniform(0, 255, (4, 9, 7, 3)).astype(np.float32)
    img[0, 0] = img[0, 0, :, :1]
    img[1, 1, :, 2] = img[1, 1, :, 0]
    hsv_j = np.asarray(jc.rgb_to_hsv(jnp.asarray(img)))
    hsv_p = pc.rgb_to_hsv(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(hsv_p, hsv_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pc.hsv_to_rgb(torch.from_numpy(hsv_j)).numpy(), np.asarray(jc.hsv_to_rgb(jnp.asarray(hsv_j))),
                               rtol=1e-5, atol=1e-4)
    for name, arg in (("adjust_hue", -0.7), ("adjust_saturation", 1.4), ("adjust_contrast", 0.6)):
        ref = np.asarray(getattr(jc, name)(jnp.asarray(img), arg))
        np.testing.assert_allclose(getattr(pc, name)(torch.from_numpy(img), arg).numpy(), ref, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_augment_image_byte_for_byte(seed):
    from casapose_tpu.data.augment import augment_batch as jax_augment_batch
    from casapose_tpu.data.augment import augment_image as jax_augment
    from casapose_tpu_torch.data.augment import augment_batch, augment_image

    rng = np.random.default_rng(100 + seed)
    img = rng.integers(0, 256, (24, 32, 3)).astype(np.uint8)
    np.testing.assert_array_equal(augment_image(img, np.random.default_rng(seed)),
                                  jax_augment(img, np.random.default_rng(seed)))
    grey = img[..., :1].copy()
    np.testing.assert_array_equal(augment_image(grey, np.random.default_rng(seed), color=False),
                                  jax_augment(grey, np.random.default_rng(seed), color=False))
    batch = np.stack([img, img[::-1]])
    np.testing.assert_array_equal(augment_batch(batch, np.random.default_rng(seed)),
                                  jax_augment_batch(batch, np.random.default_rng(seed)))


def test_loader_with_imgaug_and_record_cache(tmp_path):
    from casapose_tpu.data.ndds import VectorfieldDataset as JaxDataset
    from casapose_tpu_torch.data.ndds import VectorfieldDataset
    from tools.synthetic_scene import make_meshes, make_scene, object_names

    make_meshes(str(tmp_path / "models"))
    make_scene(str(tmp_path / "data" / "000000"), str(tmp_path / "models"), n_images=4)
    kw = dict(root=str(tmp_path / "data"), path_meshes=str(tmp_path / "models"), no_points=9,
              objectsofinterest=object_names(), noise=1e-4, random_translation=(20, 20), random_rotation=10,
              use_imgaug=True, random_crop=True, output_folder=str(tmp_path / "out"))
    batches = {}
    for tag, cls in (("jax", JaxDataset), ("port", VectorfieldDataset), ("port_cached", VectorfieldDataset)):
        ds = cls(**kw, record_cache_dir=str(tmp_path / ("cache_" + tag.split("_")[0])))
        it, n = ds.generate_dataset(2, 2, 2, (48, 64), 0.9333, 2, 2, seed=7)
        assert n == 2
        try:
            batches[tag] = [it.get_next() for _ in range(4)]
        finally:
            it.close()
    assert len(list((tmp_path / "cache_port").glob("*.npy"))) == 4
    for tag in ("port", "port_cached"):
        for ref, got in zip(batches["jax"], batches[tag]):
            assert set(ref) == set(got)
            for key in ref:
                np.testing.assert_array_equal(got[key], ref[key], err_msg=f"{tag} {key}")


def test_generator_draws_are_seeded_and_in_range():
    """Without ``draws`` the jitter and noise come from the generator: one seed, one batch; the draws in their ranges."""
    from casapose_tpu_torch.data.color import jitter_draws
    from casapose_tpu_torch.data.pipeline import prepare_device_batch

    rng = np.random.default_rng(9)
    img = torch.from_numpy(rng.integers(0, 256, (2, 12, 16, 3)).astype(np.uint8))
    seg = torch.from_numpy(rng.integers(0, 3, (2, 12, 16, 1)).astype(np.uint8))
    runs = [prepare_device_batch(img, seg, 3, generator=torch.Generator().manual_seed(s), noise=0.05, color_jitter=True,
                                 **JITTER)[0] for s in (4, 4, 5)]
    torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)
    assert not torch.equal(runs[0], runs[2]) and runs[0].abs().max() <= 1.0
    d = jitter_draws(torch.Generator().manual_seed(4), "cpu", **JITTER)
    for name, (lo, hi) in (("hue", (-0.08, 0.08)), ("saturation", (0.7, 1.3)), ("brightness", (-20.0, 20.0)),
                           ("contrast", (0.7, 1.3))):
        assert lo <= float(d[name]) <= hi, name
