"""Host batch pipeline and the device-side batch finishing, for training and evaluation.

Counterpart of ``casapose_tpu/data/pipeline.py``: sample indices ->
[thread pool] decode (or the pre-decoded record cache) + affine warp + crop
+ resize -> photometric augmentation (``use_imgaug``, data/augment.py) ->
batch assembly -> bounded prefetch queue, then :func:`prepare_device_batch`
on the device (colour jitter when imgaug is off, normalisation, Gaussian
noise, one-hot target segmentation).

Images are decoded with cv2 where it is installed, else with Pillow, as
the JAX package does; with neither, decoding raises.
"""

import glob
import hashlib
import os
import queue
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

try:
    import cv2
except ImportError:
    cv2 = None
try:
    from PIL import Image
except ImportError:
    Image = None

from casapose_tpu_torch.data.augment import augment_image
from casapose_tpu_torch.data.color import random_color_jitter


def _no_decoder(path):
    return RuntimeError(f"cannot decode {path}: neither cv2 nor Pillow is installed")


def _decode_image(path, color):
    if cv2 is not None:
        img = cv2.imread(path, cv2.IMREAD_COLOR if color else cv2.IMREAD_GRAYSCALE)
        if img is not None:
            return cv2.cvtColor(img, cv2.COLOR_BGR2RGB) if color else img[..., None]
    if Image is None:
        raise _no_decoder(path)
    img = Image.open(path)
    if color:
        return np.asarray(img.convert("RGB"), np.uint8)
    return np.asarray(img.convert("L"), np.uint8)[..., None]


def _decode_seg(path):
    if cv2 is not None:
        arr = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        # Only single-channel masks take cv2: it expands palette PNGs to BGR, losing the class ids.
        if arr is not None and arr.ndim == 2:
            return arr.astype(np.uint8)
    if Image is None:
        raise _no_decoder(path)
    arr = np.asarray(Image.open(path))
    if arr.ndim == 3:
        arr = arr[..., 0]
    return arr.astype(np.uint8)


def _warp_crop_resize(img, seg, meta, imagesize):
    """Affine warp (dst -> src convention), crop, resize, as the JAX package's loader."""
    off = meta["offsets"]
    h_crop, w_crop, out_h, out_w = int(off[0]), int(off[1]), int(off[2]), int(off[3])
    identity = abs(off[4]) < 1e-6 and abs(off[5]) < 1e-6 and abs(off[6]) < 1e-6
    if not identity and cv2 is not None:
        h, w = img.shape[:2]
        img = cv2.warpAffine(img, meta["affine"][:2], (w, h), flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP)
        if img.ndim == 2:
            img = img[..., None]
        seg = cv2.warpAffine(seg, meta["affine"][:2], (w, h), flags=cv2.INTER_NEAREST | cv2.WARP_INVERSE_MAP)
    img = img[h_crop : h_crop + out_h, w_crop : w_crop + out_w]
    seg = seg[h_crop : h_crop + out_h, w_crop : w_crop + out_w]
    if (out_h, out_w) != tuple(imagesize):
        if cv2 is not None:
            img = cv2.resize(img, (imagesize[1], imagesize[0]), interpolation=cv2.INTER_LINEAR)
            if img.ndim == 2:
                img = img[..., None]
            seg = cv2.resize(seg, (imagesize[1], imagesize[0]), interpolation=cv2.INTER_NEAREST)
        else:
            yi = (np.arange(imagesize[0]) * out_h / imagesize[0]).astype(int)
            xi = (np.arange(imagesize[1]) * out_w / imagesize[1]).astype(int)
            img = img[yi][:, xi]
            seg = seg[yi][:, xi]
    return img, seg


class RecordCache:
    """Pre-decoded frame cache: one uint8 ``.npy`` per frame (image channels ++ segmentation).

    After the first epoch each frame is one contiguous read instead of two
    PNG decodes. Entries are keyed by (size, mtime) of both source files and
    by ``params`` (every decode option that changes the stored bytes), so an
    edited frame or another option decodes again; a frame keeps at most one
    entry. Writes go through a temporary file and a rename, so workers can
    share a directory.
    """

    def __init__(self, cache_dir):
        self.dir = cache_dir
        os.makedirs(cache_dir, exist_ok=True)

    def _key(self, index, img_path, seg_path, params):
        st_i = os.stat(img_path)
        st_s = os.stat(seg_path)
        h = hashlib.sha1(
            f"{img_path}|{params}|{st_i.st_size}|{st_i.st_mtime_ns}|{st_s.st_size}|{st_s.st_mtime_ns}".encode()
        ).hexdigest()[:12]
        return os.path.join(self.dir, f"{index:07d}_{h}.npy")

    def get(self, index, img_path, seg_path, decode, params=""):
        """Return (img, seg); ``decode()`` supplies them on a miss (or a corrupt entry)."""
        path = self._key(index, img_path, seg_path, params)
        if os.path.exists(path):
            try:
                arr = np.load(path)
                return np.ascontiguousarray(arr[..., :-1]), np.ascontiguousarray(arr[..., -1])
            except (OSError, ValueError, EOFError):
                pass  # corrupt entry: decode again
        img, seg = decode()
        arr = np.concatenate([img, seg[..., None]], axis=-1)
        for stale in glob.glob(os.path.join(self.dir, f"{index:07d}_*.npy")):
            try:
                os.unlink(stale)
            except OSError:
                pass
        fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".npy.tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.save(f, arr)
            os.replace(tmp, path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
        return img, seg


def _remap_labels(seg, new_labels):
    """Raw segmentation ids -> contiguous object indices (0 = background)."""
    out = np.zeros_like(seg)
    for src, dst in new_labels:
        if dst != 0:
            out[seg == src] = dst
    return out


class BatchIterator:
    """Iterator over ``epochs`` epochs of a dataset with a bounded prefetch queue, fed by a producer thread."""

    def __init__(self, dataset, indices, epochs, batchsize, imagesize, cropratio, max_count, workers, prefetch, shuffle,
                 seed, record_cache=None, drop_remainder=True, rows=None, pin_memory=False):
        self.dataset = dataset
        self.pin_memory = pin_memory
        self.rows = rows
        self.record_cache = record_cache
        self.epochs = epochs
        self.indices = indices
        self.batchsize = batchsize
        self.drop_remainder = drop_remainder
        self.imagesize = imagesize
        self.cropratio = cropratio
        self.max_count = max_count
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.pool = ThreadPoolExecutor(max_workers=max(workers, 1))
        self.queue = queue.Queue(maxsize=max(prefetch, 2))
        self._stop = False
        self.producer = threading.Thread(target=self._produce, daemon=True)
        self.producer.start()

    def _sample(self, index, seed):
        ds = self.dataset
        rng = np.random.default_rng(seed)
        path, _, _, seg_path, _ = ds.imgs[index]
        if self.record_cache is not None:
            img, seg = self.record_cache.get(
                index, path, seg_path, lambda: (_decode_image(path, ds.color_input), _decode_seg(seg_path)),
                params=f"color={int(bool(ds.color_input))}",
            )
        else:
            img = _decode_image(path, ds.color_input)
            seg = _decode_seg(seg_path)
        meta = ds.preprocess_sample(index, self.imagesize, self.cropratio, self.max_count, rng, (img.shape[1], img.shape[0]))
        img, seg = _warp_crop_resize(img, seg, meta, self.imagesize)
        if ds.use_imgaug:
            img = augment_image(img, rng, color=ds.color_input)
        meta["img"] = img
        meta["seg"] = _remap_labels(seg, meta["new_labels"])[..., None]
        return meta

    def _emit(self, idxs):
        seeds = self.rng.integers(0, 2**63 - 1, size=len(idxs))
        if self.rows is not None:  # this rank's rows of the global batch: the same images and seeds, decoded here
            idxs, seeds = idxs[self.rows], seeds[self.rows]
        samples = list(self.pool.map(self._sample, idxs, seeds))
        batch = {}
        for key in samples[0]:
            if key == "image_id":
                batch[key] = np.asarray([[s[key]] for s in samples])
            else:
                batch[key] = np.stack([s[key] for s in samples])
                if self.pin_memory:  # page-locked: a non_blocking copy to the card then waits on no earlier step
                    batch[key] = torch.from_numpy(batch[key]).pin_memory().numpy()
        while not self._stop:
            try:
                self.queue.put(batch, timeout=1.0)
                return
            except queue.Full:
                continue

    def _produce(self):
        if not self.indices or (self.drop_remainder and len(self.indices) < self.batchsize):
            return
        for _ in range(self.epochs):
            order = np.array(self.indices)
            if self.shuffle:
                self.rng.shuffle(order)
            full_end = len(order) - len(order) % self.batchsize
            starts = list(range(0, full_end, self.batchsize))
            if not self.drop_remainder and full_end < len(order):
                starts.append(full_end)  # one short batch per epoch: no image is dropped
            for start in starts:
                if self._stop:
                    return
                self._emit(order[start : start + self.batchsize])

    def get_next(self):
        return self.queue.get()

    def close(self):
        """Stop the producer (it finishes the batch it is decoding), then the decode pool."""
        self._stop = True
        self.producer.join(timeout=60)
        self.pool.shutdown(wait=False)


def make_dataset(dataset, batchsize, epochs, prefetch, imagesize, cropratio, worker, no_objects, shuffle=True,
                 mirrored_strategy=None, seed=None, record_cache_dir=None, drop_remainder=True, rows=None,
                 pin_memory=False):
    """The JAX package's ``generate_dataset`` signature: returns (iterator, batches per epoch).

    The iterator yields ``epochs`` epochs; the JAX package's loops forever.
    ``drop_remainder=False`` keeps every image: the epoch ends with one short batch.
    ``rows`` (a slice of the global batch of ``batchsize``) makes the iterator
    yield only those rows of each batch, decoding only them: a data-parallel
    rank's share (``parallel/mesh.py``). ``pin_memory`` makes the producer
    put each array of a batch (but ``image_id``) in page-locked memory, still
    as numpy arrays, so that ``torch.from_numpy(a).to(card, non_blocking=True)``
    is an asynchronous copy.
    """
    del no_objects, mirrored_strategy
    record_cache_dir = record_cache_dir or getattr(dataset, "record_cache_dir", None)
    n = len(dataset.imgs)
    data_size = n - n % batchsize if drop_remainder else n
    epoch_batches = data_size // batchsize if drop_remainder else -(-data_size // batchsize)
    it = BatchIterator(
        dataset, list(range(data_size)), epochs, batchsize, imagesize, cropratio, max_count=1, workers=worker or 8,
        prefetch=prefetch or 4, shuffle=shuffle, seed=seed,
        record_cache=RecordCache(record_cache_dir) if record_cache_dir else None, drop_remainder=drop_remainder,
        rows=rows, pin_memory=pin_memory,
    )
    return it, epoch_batches


def prepare_device_batch(img_u8, labelmap, num_classes, generator=None, noise=0.0, brightness=0.0, contrast=0.0,
                         saturation=0.0, hue=0.0, color_jitter=False, normal=(0.5, 0.5), grayscale_to_rgb=False,
                         draws=None, rows=None):
    """Device-side batch finishing of the train and eval steps.

    uint8 image [b, h, w, c] -> colour jitter on the RAW 0..255 scale when
    ``color_jitter`` (data/color.py) -> (x / 255 - m) / s -> Gaussian noise
    with ONE batch-level std ~ U(0, ``noise``), clipped to [-1, 1] -> grey
    repeated to RGB if asked; label map [b, h, w, 1] -> one-hot target
    segmentation [b, h, w, num_classes] float32.

    The random ops run only with a source of draws, as the JAX function's run
    only with a key: ``generator`` (a ``torch.Generator`` on the batch's
    device), or ``draws``, a dict of the values themselves (``hue``,
    ``saturation``, ``brightness``, ``contrast``, ``noise_std`` and
    ``noise``, the standard-normal tensor of the image's shape), which the
    tests fill with the JAX package's numbers. ``rows`` ((first row, global
    batch size)) says that the batch is one data-parallel rank's rows of a
    global batch: the generator then draws the global batch's noise and the
    rows take theirs, so every rank of a group draws what one process would.
    """
    img = img_u8.to(torch.float32)
    random = generator is not None or draws is not None
    if color_jitter and random:
        img = random_color_jitter(img, generator, hue=hue, saturation=saturation, brightness=brightness,
                                  contrast=contrast, color=img.shape[-1] == 3, draws=draws)
    img = (img / 255.0 - normal[0]) / normal[1]
    if noise > 0 and random:
        if draws is None:
            std = torch.rand(1, generator=generator, device=img.device) * noise
            if rows is None:
                gauss = torch.randn(img.shape, generator=generator, device=img.device)
            else:
                first, global_b = rows
                gauss = torch.randn((global_b,) + tuple(img.shape[1:]), generator=generator, device=img.device)
                gauss = gauss[first : first + img.shape[0]]
        else:
            std, gauss = draws["noise_std"], draws["noise"]
        img = torch.clamp(img + gauss * std, -1.0, 1.0)
    if grayscale_to_rgb and img.shape[-1] == 1:
        img = img.repeat(1, 1, 1, 3)
    labels = labelmap[..., 0].to(torch.int64)
    target_seg = (labels[..., None] == torch.arange(num_classes, device=labels.device)).to(torch.float32)
    return img, target_seg
