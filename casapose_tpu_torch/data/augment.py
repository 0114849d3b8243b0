"""Host-side photometric augmentation (numpy + cv2): ``augment_image`` / ``augment_batch``.

A copy of ``casapose_tpu/data/augment.py`` (the port imports nothing of the
JAX package, and the card's machine has no imgaug): the reference's imgaug
pipelines rebuilt with numpy and cv2. The colour path mirrors the
PyraPose-style ``seq`` (five shuffled groups: blur SomeOf(0, 2), hue and
saturation Sometimes(0.5), a brightness OneOf(4) with FrequencyNoiseAlpha,
contrast SomeOf(0, 2), noise SomeOf(0, 3) over 8 members); the greyscale
path mirrors ``seq_grayscale`` (nine independently gated stages, shuffled,
no noise and no sigmoid contrast). For one ``numpy.random.Generator`` state
and one cv2 build, the output equals the JAX package's byte for byte.
"""

import numpy as np

try:
    import cv2
except ImportError:
    cv2 = None


def _maybe_per_channel(rng, shape_c, lo, hi, per_channel_p=0.5):
    if rng.uniform() < per_channel_p:
        return rng.uniform(lo, hi, size=(1, 1, shape_c)).astype(np.float32)
    return np.float32(rng.uniform(lo, hi))


# ---------------------------------------------------------------- blur ops


def _keep_channels(out, img):
    """cv2 returns HxW for single-channel HxWx1 input; restore the axis."""
    return out[..., None] if out.ndim < img.ndim else out


def _gaussian_blur(img, rng):
    """iaa.GaussianBlur((0.0, 2.0))"""
    if cv2 is None:
        return img
    sigma = rng.uniform(0.0, 2.0)
    if sigma < 1e-3:
        return img
    return _keep_channels(cv2.GaussianBlur(img, (0, 0), sigma), img)


def _average_blur(img, rng):
    """iaa.AverageBlur(k=(3, 7)) — discrete uniform incl. even k."""
    if cv2 is None:
        return img
    k = int(rng.integers(3, 8))
    return _keep_channels(cv2.blur(img, (k, k)), img)


def _median_blur(img, rng):
    """iaa.MedianBlur(k=(3, 7)) — odd k only (cv2 requirement too)."""
    if cv2 is None:
        return img
    k = int(rng.integers(1, 4)) * 2 + 1  # 3, 5, 7
    return _keep_channels(cv2.medianBlur(img, k), img)


def _motion_blur(img, rng):
    """iaa.MotionBlur(k=(3, 7)) — line kernel at a uniform angle."""
    if cv2 is None:
        return img
    k = int(rng.integers(3, 8))
    kernel = np.zeros((k, k), np.float32)
    angle = rng.uniform(0, 360)
    c = (k - 1) / 2
    dx, dy = np.cos(np.deg2rad(angle)), np.sin(np.deg2rad(angle))
    for t in np.linspace(-c, c, k * 2):
        x, y = int(round(c + t * dx)), int(round(c + t * dy))
        if 0 <= x < k and 0 <= y < k:
            kernel[y, x] = 1
    kernel /= max(kernel.sum(), 1)
    return _keep_channels(cv2.filter2D(img, -1, kernel), img)


def _bilateral_blur(img, rng):
    """iaa.BilateralBlur(d=(1, 7)) — color path only."""
    if cv2 is None or img.shape[-1] != 3:
        return img
    d = int(rng.integers(1, 8))
    return cv2.bilateralFilter(img, d, 75, 75)


# --------------------------------------------------------------- color ops


def _add_to_hue_and_saturation(img, rng, lo=-15, hi=15):
    """iaa.AddToHueAndSaturation((-15, 15))"""
    if cv2 is None or img.shape[-1] != 3:
        return img
    hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV).astype(np.int16)
    hsv[..., 0] = (hsv[..., 0] + int(rng.uniform(lo, hi) * 180 / 255)) % 180
    hsv[..., 1] = np.clip(hsv[..., 1] + int(rng.uniform(lo, hi)), 0, 255)
    return cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2RGB)


# ---------------------------------------------------- brightness / contrast


def _add(img, rng):
    """iaa.Add((-10, 10), per_channel=0.5)"""
    x = img.astype(np.float32) + _maybe_per_channel(rng, img.shape[-1], -10, 10)
    return np.clip(x, 0, 255).astype(np.uint8)


def _multiply(img, rng):
    """iaa.Multiply((0.75, 1.25), per_channel=0.5)"""
    x = img.astype(np.float32) * _maybe_per_channel(rng, img.shape[-1], 0.75, 1.25)
    return np.clip(x, 0, 255).astype(np.uint8)


def _gamma_contrast(img, rng):
    """iaa.GammaContrast((0.75, 1.25), per_channel=0.5)"""
    x = img.astype(np.float32) / 255.0
    x = np.power(np.clip(x, 1e-6, 1.0), _maybe_per_channel(rng, img.shape[-1], 0.75, 1.25))
    return np.clip(x * 255.0, 0, 255).astype(np.uint8)


def _sigmoid_contrast(img, rng):
    """iaa.SigmoidContrast(gain=(5, 10), cutoff=(0.25, 0.75), per_channel=0.5)"""
    x = img.astype(np.float32) / 255.0
    gain = _maybe_per_channel(rng, img.shape[-1], 5, 10)
    cutoff = np.float32(rng.uniform(0.25, 0.75))
    x = 1.0 / (1.0 + np.exp(gain * (cutoff - x)))
    return np.clip(x * 255.0, 0, 255).astype(np.uint8)


def _log_contrast(img, rng):
    """iaa.LogContrast(gain=(0.75, 1.0), per_channel=0.5)"""
    x = img.astype(np.float32) / 255.0
    gain = _maybe_per_channel(rng, img.shape[-1], 0.75, 1.0)
    x = gain * np.log2(1.0 + x)
    return np.clip(x * 255.0, 0, 255).astype(np.uint8)


def _linear_contrast(img, rng):
    """iaa.LinearContrast(alpha=(0.7, 1.3), per_channel=0.5) — also the
    ``ContrastNormalization`` member inside FrequencyNoiseAlpha."""
    x = img.astype(np.float32) / 255.0
    alpha = _maybe_per_channel(rng, img.shape[-1], 0.7, 1.3)
    x = 0.5 + alpha * (x - 0.5)
    return np.clip(x * 255.0, 0, 255).astype(np.uint8)


def _frequency_noise_alpha(img, rng):
    """iaa.FrequencyNoiseAlpha(exponent=(-4, 0), first=Multiply(0.75, 1.25),
    second=ContrastNormalization(0.7, 1.3)) — reference
    augmentation_model.py:78-82: blend the two branch outputs with a smooth
    power-law-spectrum alpha mask (exponent -4 = very smooth, 0 = white)."""
    h, w = img.shape[:2]
    exponent = rng.uniform(-4.0, 0.0)
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.fftfreq(w)[None, :]
    f = np.sqrt(fy * fy + fx * fx)
    f[0, 0] = 1.0 / max(h, w)  # keep the DC term finite
    spectrum = (rng.normal(size=(h, w)) + 1j * rng.normal(size=(h, w))) * np.power(f, exponent)
    noise = np.real(np.fft.ifft2(spectrum))
    span = float(noise.max() - noise.min())
    alpha = (noise - noise.min()) / max(span, 1e-8)
    first = _multiply(img, rng).astype(np.float32)
    second = _linear_contrast(img, rng).astype(np.float32)
    out = alpha[..., None] * first + (1.0 - alpha[..., None]) * second
    return np.clip(out, 0, 255).astype(np.uint8)


def _brightness_oneof(img, rng):
    """The reference's brightness OneOf (augmentation_model.py:68-84):
    [Add+Multiply, Add, Multiply, FrequencyNoiseAlpha] — one at p=1/4 each."""
    choice = rng.integers(0, 4)
    if choice == 0:
        return _multiply(_add(img, rng), rng)
    if choice == 1:
        return _add(img, rng)
    if choice == 2:
        return _multiply(img, rng)
    return _frequency_noise_alpha(img, rng)


# ---------------------------------------------------------------- noise ops


def _additive_gaussian_noise(img, rng):
    """iaa.AdditiveGaussianNoise(scale=(0, 0.05), per_channel=0.5)"""
    scale = rng.uniform(0, 0.05) * 255
    per_c = rng.uniform() < 0.5
    shape = img.shape if per_c else img.shape[:2] + (1,)
    x = img.astype(np.float32) + rng.normal(0, max(scale, 1e-6), size=shape)
    return np.clip(x, 0, 255).astype(np.uint8)


def _additive_laplace_noise(img, rng):
    """iaa.AdditiveLaplaceNoise(scale=(0, 0.05), per_channel=0.5)"""
    scale = rng.uniform(0, 0.05) * 255
    per_c = rng.uniform() < 0.5
    shape = img.shape if per_c else img.shape[:2] + (1,)
    x = img.astype(np.float32) + rng.laplace(0, max(scale, 1e-6), size=shape)
    return np.clip(x, 0, 255).astype(np.uint8)


def _additive_poisson_noise(img, rng):
    """iaa.AdditivePoissonNoise(lam=(0, 8), per_channel=0.5) — imgaug adds
    RandomSign(Poisson(lam)) samples, i.e. symmetric, not mean-shifted."""
    lam = rng.uniform(0, 8)
    per_c = rng.uniform() < 0.5
    shape = img.shape if per_c else img.shape[:2] + (1,)
    n = rng.poisson(lam, size=shape) * rng.choice([-1.0, 1.0], size=shape)
    return np.clip(img.astype(np.float32) + n, 0, 255).astype(np.uint8)


def _dropout(img, rng):
    """iaa.Dropout(p=(0, 0.05), per_channel=0.5)"""
    p = rng.uniform(0, 0.05)
    per_c = rng.uniform() < 0.5
    shape = img.shape if per_c else img.shape[:2] + (1,)
    x = img.astype(np.float32) * (rng.uniform(size=shape) >= p)
    return np.clip(x, 0, 255).astype(np.uint8)


def _salt_and_pepper(img, rng, salt=True, pepper=True, per_channel=False):
    """iaa.SaltAndPepper(p=(0, 0.05)); Salt/Pepper via the flags;
    ImpulseNoise == SaltAndPepper(per_channel=True)."""
    p = rng.uniform(0, 0.05)
    shape = img.shape if per_channel else img.shape[:2] + (1,)
    m = rng.uniform(size=shape)
    x = img.astype(np.float32)
    if pepper:
        x = np.where(m < p / (2.0 if salt else 1.0), 0.0, x)
    if salt:
        x = np.where(m > 1 - p / (2.0 if pepper else 1.0), 255.0, x)
    return np.clip(x, 0, 255).astype(np.uint8)


def _impulse_noise(img, rng):
    return _salt_and_pepper(img, rng, per_channel=True)


def _salt(img, rng):
    return _salt_and_pepper(img, rng, pepper=False)


def _pepper(img, rng):
    return _salt_and_pepper(img, rng, salt=False)


# ------------------------------------------------------------- family tables

# seq (color): five top-level groups, applied in random order.
COLOR_BLUR_MEMBERS = [_gaussian_blur, _average_blur, _median_blur, _bilateral_blur, _motion_blur]
COLOR_CONTRAST_MEMBERS = [_gamma_contrast, _sigmoid_contrast, _log_contrast, _linear_contrast]
COLOR_NOISE_MEMBERS = [
    _additive_gaussian_noise,
    _additive_laplace_noise,
    _additive_poisson_noise,
    _dropout,
    _impulse_noise,
    _salt_and_pepper,
    _salt,
    _pepper,
]

# seq_grayscale: nine independently-gated stages (fn, probability), shuffled.
# Reference augmentation_model.py:7-21 — NO noise stage, NO sigmoid, NO hue.
GRAYSCALE_FAMILY = [
    (_gaussian_blur, 0.2),
    (_average_blur, 0.2),
    (_median_blur, 0.2),
    (_motion_blur, 0.2),
    (_add, 0.5),
    (_multiply, 0.5),
    (_gamma_contrast, 0.5),
    (_log_contrast, 0.5),
    (_linear_contrast, 0.5),
]


def _someof(img, rng, members, max_n):
    """iaa.SomeOf((0, max_n), members): pick 0..max_n distinct members,
    apply in list order (imgaug SomeOf default random_order=False)."""
    n = int(rng.integers(0, max_n + 1))
    if n == 0:
        return img
    picked = sorted(rng.choice(len(members), size=min(n, len(members)), replace=False))
    for i in picked:
        img = members[i](img, rng)
    return img


def _seq_color(img, rng):
    """The PyraPose-style ``seq`` — groups shuffled per image."""
    groups = [
        lambda im, r: _someof(im, r, COLOR_BLUR_MEMBERS, 2),
        lambda im, r: _add_to_hue_and_saturation(im, r) if r.uniform() < 0.5 else im,
        _brightness_oneof,
        lambda im, r: _someof(im, r, COLOR_CONTRAST_MEMBERS, 2),
        lambda im, r: _someof(im, r, COLOR_NOISE_MEMBERS, 3),
    ]
    for i in rng.permutation(len(groups)):
        img = groups[i](img, rng)
    return img


def _seq_grayscale(img, rng):
    """``seq_grayscale`` — each stage independently at its probability,
    random order (iaa.Sequential(random_order=True) of Sometimes(p, op))."""
    for i in rng.permutation(len(GRAYSCALE_FAMILY)):
        fn, p = GRAYSCALE_FAMILY[i]
        if rng.uniform() < p:
            img = fn(img, rng)
    return img


def augment_image(img, rng=None, color=True):
    """Apply the reference-matched photometric pipeline to one uint8 image."""
    if rng is None:
        rng = np.random.default_rng()
    return _seq_color(img, rng) if color else _seq_grayscale(img, rng)


def augment_batch(images, rng=None, color=True):
    """Augment a uint8 batch [b, h, w, c] independently per image."""
    if rng is None:
        rng = np.random.default_rng()
    return np.stack([augment_image(images[i], rng, color=color) for i in range(len(images))])
