"""Device-side colour jitter with tf.image semantics.

Counterpart of ``casapose_tpu/data/color.py``. The reference's augmentation
without imgaug applies, to the RAW 0..255 float batch, four batch-level
random ops in this order: hue (delta ~ U(-hue, hue)), saturation (factor ~
U(1-s, 1+s)), brightness (delta ~ U(-b, b), on the raw scale: a reference
quirk, kept) and contrast (factor ~ U(1-c, 1+c), per channel about the
image mean). Each draws ONE scalar for the whole batch; greyscale inputs
skip hue and saturation.

The draws come from an explicit ``torch.Generator``, or are handed in as
``draws=`` (the JAX package draws from threefry, which no torch generator
reproduces, so the tests hand the port the JAX package's own numbers).
"""

import torch


def rgb_to_hsv(img):
    """[..., 3] RGB (any non-negative scale) -> HSV with V on the input scale; tf.image's piecewise hue."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    c = v - minc
    one = torch.ones_like(c)
    zero = torch.zeros_like(c)
    safe_c = torch.where(c > 0, c, one)
    s = torch.where(v > 0, c / torch.where(v > 0, v, one), zero)
    h = torch.where(v == r, (g - b) / safe_c, torch.where(v == g, 2.0 + (b - r) / safe_c, 4.0 + (r - g) / safe_c))
    h = torch.where(c > 0, torch.remainder(h / 6.0, 1.0), zero)
    return torch.stack([h, s, v], dim=-1)


def hsv_to_rgb(img):
    """Inverse of :func:`rgb_to_hsv` (V keeps its scale)."""
    h, s, v = img[..., 0], img[..., 1], img[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)

    def select(*choices):  # jnp.select over i == 0 .. 5 (its default 0 is never reached)
        out = torch.zeros_like(v)
        for k in reversed(range(6)):
            out = torch.where(i == k, choices[k], out)
        return out

    return torch.stack([select(v, q, p, p, t, v), select(t, v, v, q, p, p), select(p, p, t, v, v, q)], dim=-1)


def adjust_hue(img, delta):
    """tf.image.adjust_hue: rotate the hue by ``delta`` (mod 1)."""
    hsv = rgb_to_hsv(img)
    h = torch.remainder(hsv[..., 0] + delta, 1.0)
    return hsv_to_rgb(torch.stack([h, hsv[..., 1], hsv[..., 2]], dim=-1))


def adjust_saturation(img, factor):
    """tf.image.adjust_saturation: scale S, clipped to [0, 1]."""
    hsv = rgb_to_hsv(img)
    s = torch.clamp(hsv[..., 1] * factor, 0.0, 1.0)
    return hsv_to_rgb(torch.stack([hsv[..., 0], s, hsv[..., 2]], dim=-1))


def adjust_brightness(img, delta):
    """tf.image.adjust_brightness: add ``delta`` on the input scale."""
    return img + delta


def adjust_contrast(img, factor):
    """tf.image.adjust_contrast: per channel (x - mean_HW) * factor + mean_HW."""
    mean = torch.mean(img, dim=(-3, -2), keepdim=True)
    return (img - mean) * factor + mean


def jitter_draws(generator, device, hue=0.0, saturation=0.0, brightness=0.0, contrast=0.0):
    """The four batch-level draws, in the reference's order, as scalar tensors on ``device`` (no host sync)."""
    u = torch.rand(4, generator=generator, device=device)
    return {
        "hue": (2.0 * u[0] - 1.0) * hue,
        "saturation": 1.0 - saturation + 2.0 * saturation * u[1],
        "brightness": (2.0 * u[2] - 1.0) * brightness,
        "contrast": 1.0 - contrast + 2.0 * contrast * u[3],
    }


def random_color_jitter(img, generator=None, hue=0.0, saturation=0.0, brightness=0.0, contrast=0.0, color=True,
                        draws=None):
    """The reference's jitter without imgaug on the RAW 0..255 float batch ``img`` [b, h, w, c].

    ``draws`` ({"hue", "saturation", "brightness", "contrast"}: the values
    themselves, as :func:`jitter_draws` returns them) replaces the generator's.
    """
    if draws is None:
        draws = jitter_draws(generator, img.device, hue, saturation, brightness, contrast)
    if color and hue > 0:
        img = adjust_hue(img, draws["hue"])
    if color and saturation > 0:
        img = adjust_saturation(img, draws["saturation"])
    if brightness > 0:
        img = adjust_brightness(img, draws["brightness"])
    if contrast > 0:
        img = adjust_contrast(img, draws["contrast"])
    return img
