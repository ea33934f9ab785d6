"""Datasets and batching, counterpart of ``dct_cryptonets_tpu.data.pipeline``
(synthetic data, the handwritten digits, seeded splits, batch iteration).

Datasets are host-side uint8 image arrays; batches are assembled with numpy
and the codec (``data.codec.dct_ingest``) runs on the batch's device.  The
split reproduces sklearn's ``train_test_split`` (``ShuffleSplit``) index
permutation with ``np.random.RandomState``, so both packages pick the same
subsets without sklearn.  The CIFAR-10, ImageFolder and JSON manifest
loaders are not ported yet.
"""
import gzip
import math
import os

import numpy as np


class ArrayDataset:
    """images: (N, H, W, 3) uint8 RGB; labels: (N,) int."""

    def __init__(self, images, labels, classes=None):
        self.images = images
        self.labels = labels
        self.classes = classes or [str(i) for i in range(int(labels.max()) + 1)]

    def __len__(self):
        return len(self.images)

    def gather(self, idx):
        """(images, labels) for an index array."""
        return self.images[idx], self.labels[idx]


def load_synthetic(num: int = 2048, image_size: int = 32,
                   num_classes: int = 10, seed: int = 0) -> ArrayDataset:
    """Deterministic class-structured random images: each class has a color
    + frequency signature so models can actually fit them (the same images
    as the JAX package for the same arguments)."""
    from scipy.ndimage import zoom
    rng = np.random.default_rng(seed)
    y = rng.integers(0, num_classes, num).astype(np.int32)
    base = rng.integers(64, 192, (num_classes, 4, 4, 3)).astype(np.float64)
    z = image_size / 4
    templates = np.stack([zoom(b, (z, z, 1), order=1) for b in base])
    x = np.empty((num, image_size, image_size, 3), np.uint8)
    for i in range(num):
        noise = zoom(rng.normal(0, 20, (8, 8, 3)), (image_size / 8,) * 2 + (1,),
                     order=1)
        x[i] = np.clip(templates[y[i]] + noise, 0, 255).astype(np.uint8)
    return ArrayDataset(x, y)


# UCI "Optical Recognition of Handwritten Digits" (1,797 8x8 images, 64
# pixel columns and the label), the copy shipped by scikit-learn as
# sklearn/datasets/data/digits.csv.gz
DIGITS_CSV = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "digits.csv.gz")


def load_digits_dataset(train: bool = True, image_size: int = 32
                        ) -> ArrayDataset:
    """The handwritten digits upscaled to ``image_size`` RGB, split 80/20
    as the JAX package splits them (the same images and labels).  Parsed
    as ``sklearn.datasets.load_digits`` parses its CSV, without sklearn."""
    from scipy.ndimage import zoom
    with gzip.open(DIGITS_CSV, mode="rt", encoding="utf-8") as fh:
        data = np.loadtxt(fh, delimiter=",")
    images = data[:, :-1].reshape(-1, 8, 8)
    target = data[:, -1].astype(int)
    x8 = (images / 16.0 * 255.0).astype(np.float64)
    z = image_size / 8
    x = np.stack([zoom(im, (z, z), order=1) for im in x8])
    x = np.clip(x, 0, 255).astype(np.uint8)[..., None].repeat(3, axis=-1)
    y = target.astype(np.int32)
    tr_idx, te_idx = train_val_split(len(y), 0.2)
    idx = tr_idx if train else te_idx
    return ArrayDataset(np.ascontiguousarray(x[idx]), y[idx],
                        [str(i) for i in range(10)])


def train_val_split(n: int, test_size, random_state: int = 42):
    """(train_idx, test_idx) of sklearn's ``train_test_split(np.arange(n),
    test_size=test_size, random_state=random_state)``: one
    ``RandomState(random_state).permutation(n)``, test first."""
    if isinstance(test_size, (float, np.floating)):
        if not 0.0 < test_size < 1.0:
            raise ValueError(f"test_size={test_size} must be in (0, 1)")
        n_test = math.ceil(test_size * n)
    else:
        n_test = int(test_size)
        if not 0 < n_test < n:
            raise ValueError(f"test_size={test_size} must be in (0, {n})")
    perm = np.random.RandomState(random_state).permutation(n)
    return perm[n_test:], perm[:n_test]


def batches(ds, idx, batch_size: int, *, shuffle: bool,
            seed: int = 0, drop_remainder: bool = True):
    """Yield (images, labels) numpy batches over the given indices."""
    idx = np.asarray(idx)
    if shuffle:
        idx = idx[np.random.default_rng(seed).permutation(len(idx))]
    end = len(idx) - (len(idx) % batch_size) if drop_remainder else len(idx)
    for s in range(0, end, batch_size):
        yield ds.gather(idx[s:s + batch_size])


def get_dataset(name: str, path: str | None, train: bool, *,
                image_size: int = 32, num_classes: int = 10,
                synthetic_size: int = 2048):
    if name == "synthetic":
        return load_synthetic(synthetic_size if train else synthetic_size // 4,
                              image_size, num_classes,
                              seed=0 if train else 1)
    if name == "digits":
        return load_digits_dataset(train, image_size)
    raise NotImplementedError(
        f"dataset {name!r} is not yet ported; use --dataset synthetic or "
        "digits")
