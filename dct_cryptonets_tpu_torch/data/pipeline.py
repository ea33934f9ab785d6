"""Datasets and batching, counterpart of ``dct_cryptonets_tpu.data.pipeline``
(the datasets, seeded splits, batch iteration).

Datasets are host-side uint8 image arrays; batches are assembled with numpy
and the codec (``data.codec.dct_ingest``) runs on the batch's device.  The
split reproduces sklearn's ``train_test_split`` (``ShuffleSplit``) index
permutation with ``np.random.RandomState``, so both packages pick the same
subsets without sklearn.

Datasets (``get_dataset``):
  * ``cifar10``    -- the python-pickle ``cifar-10-batches-py/`` batches;
  * ``synthetic``  -- deterministic class-structured random images;
  * ``digits``     -- the handwritten digits (the port's own CSV copy);
  * ``ImageNet``, ``Imagenette``, ``miniImagenet`` -- ImageFolder layouts
                     (class subdirectories under a split directory),
                     decoded lazily per batch with PIL;
  * ``*.json``     -- a ``{image_names, image_labels}`` manifest, decoded
                     lazily per batch with PIL.

Both lazy loaders decode with PIL, as the JAX package's do, so they give
its bytes.  Two of its behaviours are kept as they are (ROADMAP Queue 3):
a manifest reached through ``get_dataset`` is opened without an image
size, so a manifest of mixed sizes cannot be stacked into a batch; and a
folder image, already resized to 1.15 P and center-cropped to P, is
resized and cropped once more by the eval ingest (``dct_ingest``).
"""
import gzip
import json
import math
import os
import pickle

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


def _pil_image():
    """``PIL.Image``: only the lazy loaders need Pillow, at their first
    decode."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("the ImageFolder and JSON manifest datasets decode "
                          "images with Pillow (PIL), which is not "
                          "installed") from e
    return Image


class FolderDataset:
    """Lazy ImageFolder (class-subdirectory) dataset: classes are the sorted
    subdirectories, images their sorted .jpg/.jpeg/.png/.bmp files, decoded
    per batch in :meth:`gather`."""

    def __init__(self, root: str, image_size: int = 224):
        self.image_size = image_size
        self.classes = sorted(d for d in os.listdir(root)
                              if os.path.isdir(os.path.join(root, d)))
        if not self.classes:
            raise FileNotFoundError(f"no class subdirectories under {root}")
        self.paths, labels = [], []
        for ci, c in enumerate(self.classes):
            cdir = os.path.join(root, c)
            for f in sorted(os.listdir(cdir)):
                if f.lower().endswith((".jpg", ".jpeg", ".png", ".bmp")):
                    self.paths.append(os.path.join(cdir, f))
                    labels.append(ci)
        self.labels = np.asarray(labels, np.int32)

    def __len__(self):
        return len(self.paths)

    def _load(self, path):
        """The reference's eval geometry: the shorter side resized to
        1.15 s (PIL bilinear), then a center crop of s."""
        Image = _pil_image()
        img = Image.open(path).convert("RGB")
        s = self.image_size
        w, h = img.size
        scale = (1.15 * s) / min(w, h)
        img = img.resize((max(s, round(w * scale)), max(s, round(h * scale))),
                         Image.BILINEAR)
        w, h = img.size
        l, t = (w - s) // 2, (h - s) // 2
        return np.asarray(img.crop((l, t, l + s, t + s)), np.uint8)

    def gather(self, idx):
        imgs = np.stack([self._load(self.paths[i]) for i in np.asarray(idx)])
        return imgs, self.labels[np.asarray(idx)]


CIFAR10_CLASSES = ["airplane", "automobile", "bird", "cat", "deer",
                   "dog", "frog", "horse", "ship", "truck"]


def load_cifar10(root: str, train: bool = True) -> ArrayDataset:
    """The python-pickle CIFAR-10 batches under
    ``root/cifar-10-batches-py``: ``data_batch_1..5`` (train) or
    ``test_batch``, each a 10,000 x 3072 uint8 ``data`` (R, G, B planes of
    32 x 32) and a ``labels`` list, as (N, 32, 32, 3) uint8."""
    d = os.path.join(root, "cifar-10-batches-py")
    files = ([f"data_batch_{i}" for i in range(1, 6)] if train
             else ["test_batch"])
    xs, ys = [], []
    for f in files:
        path = os.path.join(d, f)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"CIFAR-10 batch {path} not found — pass --dataset synthetic "
                "or provide the python-pickle batches")
        with open(path, "rb") as fh:
            batch = pickle.load(fh, encoding="bytes")
        xs.append(batch[b"data"])
        ys.append(batch[b"labels"])
    x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    y = np.concatenate([np.asarray(b) for b in ys])
    return ArrayDataset(np.ascontiguousarray(x), y.astype(np.int32),
                        list(CIFAR10_CLASSES))


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


class ManifestDataset:
    """Lazy JSON manifest ``{image_names, image_labels[, label_names]}``
    (reference data/dataset.py:11-34): construction reads the metadata
    only; images decode per batch in :meth:`gather`, resized to
    ``image_size`` square (PIL bilinear) when one is given."""

    def __init__(self, path: str, image_size: int | None = None):
        with open(path) as f:
            meta = json.load(f)
        self.paths = meta["image_names"]
        self.labels = np.asarray(meta["image_labels"], np.int32)
        self.classes = meta.get("label_names") or [
            str(i) for i in range(int(self.labels.max()) + 1)]
        self.image_size = image_size

    def __len__(self):
        return len(self.paths)

    def _load(self, path):
        Image = _pil_image()
        img = Image.open(path).convert("RGB")
        if self.image_size is not None and img.size != (self.image_size,) * 2:
            img = img.resize((self.image_size, self.image_size),
                             Image.BILINEAR)
        return np.asarray(img, np.uint8)

    def gather(self, idx):
        imgs = np.stack([self._load(self.paths[i]) for i in np.asarray(idx)])
        return imgs, self.labels[np.asarray(idx)]


def load_json_manifest(path: str, image_size: int | None = None
                       ) -> ManifestDataset:
    """Open a JSON manifest lazily (images decode per batch, not here)."""
    return ManifestDataset(path, image_size)


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
    if name == "cifar10":
        return load_cifar10(path or "./cifardataset", train)
    if name == "synthetic":
        return load_synthetic(synthetic_size if train else synthetic_size // 4,
                              image_size, num_classes,
                              seed=0 if train else 1)
    if name == "digits":
        return load_digits_dataset(train, image_size)
    if name in ("ImageNet", "Imagenette", "miniImagenet"):
        # the ImageFolder layouts of scripts/install_datasets.sh and their
        # usual split subdirectories (reference train.py:266-314)
        root = path or "."
        for split_dir in (("train",) if train else ("val", "validation",
                                                    "test")):
            cand = os.path.join(root, split_dir)
            if os.path.isdir(cand):
                return FolderDataset(cand, image_size)
        raise FileNotFoundError(
            f"no {'train' if train else 'val/test'} split under {root} — "
            "run scripts/install_datasets.sh or pass --dataset_path")
    if name.endswith(".json"):
        # no image_size: a manifest of mixed sizes cannot be stacked
        # (the JAX package's behaviour, ROADMAP Queue 3)
        return load_json_manifest(name)
    raise ValueError(f"unknown dataset {name!r}")
