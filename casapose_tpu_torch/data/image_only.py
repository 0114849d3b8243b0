"""Bare image stream for inference latency benchmarks.

Copy of ``casapose_tpu/data/image_only.py`` (a numpy/PIL host module), itself a
rebuild of casapose/data_handler/image_only_dataset.py: recursive scan for
``*[0-9].png/jpg`` images, decode, normalize, batch.
"""

import glob
import os

import numpy as np
from PIL import Image


class ImageOnlyDataset:
    def __init__(self, root, normal=(0.5, 0.5), data_size=None):
        self.normal = normal
        self.data_size = data_size
        self.imgs = []

        def explore(path):
            if not os.path.isdir(path):
                return
            folders = [os.path.join(path, o) for o in sorted(os.listdir(path)) if os.path.isdir(os.path.join(path, o))]
            if folders:
                for folder in folders:
                    explore(folder)
            else:
                for ext in ("png", "jpg"):
                    for f in sorted(glob.glob(path + f"/*[0-9].{ext}")):
                        self.imgs.append(f)

        explore(root)

    def __len__(self):
        if self.data_size is not None:
            return int(self.data_size)
        return len(self.imgs)

    def generate_dataset(self, batchsize=1, normalized=True):
        """Yield image batches [b, h, w, 3]; float normalized by default."""
        n = len(self) - (len(self) % batchsize)

        def iterator():
            batch = []
            for path in self.imgs[:n]:
                img = np.asarray(Image.open(path).convert("RGB"), np.uint8)
                batch.append(img)
                if len(batch) == batchsize:
                    out = np.stack(batch)
                    if normalized:
                        out = ((out.astype(np.float32) / 255.0) - self.normal[0]) / self.normal[1]
                    yield out
                    batch = []

        return iterator(), n // batchsize
