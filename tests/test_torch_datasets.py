"""The port's datasets against the JAX package's, on fixtures the tests
write in the published layouts: the python-pickle ``cifar-10-batches-py/``
batches, ImageFolder class subdirectories under a split directory, and a
``{image_names, image_labels}`` JSON manifest.  Both packages decode with
PIL, so images, labels and classes are equal bit for bit.  Also: both
CLIs on ``--dataset cifar10`` (the default), the two JAX-package quirks the
port keeps (ROADMAP Queue 3), and ``--profile_dir``."""
import glob
import json
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dct_cryptonets_tpu import train as JTRAIN
from dct_cryptonets_tpu.data import codec as JC
from dct_cryptonets_tpu.data import pipeline as JPIPE
from dct_cryptonets_tpu.models import resnet as JRES
from dct_cryptonets_tpu_torch import homomorphic_eval as HE
from dct_cryptonets_tpu_torch import train as TRAIN
from dct_cryptonets_tpu_torch.data import codec as PC
from dct_cryptonets_tpu_torch.data import pipeline as PIPE
from dct_cryptonets_tpu_torch.models import resnet as RES

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "checkpoints", "digits_flagship", "best.tar")


def write_cifar10(root, n_train=32, n_test=40, seed=0):
    """Five ``data_batch_*`` of ``n_train`` images and a ``test_batch`` of
    ``n_test`` (class-structured, from ``load_synthetic``), pickled with
    bytes keys as the published batches load under
    ``encoding="bytes"``."""
    d = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(d, exist_ok=True)
    ds = PIPE.load_synthetic(5 * n_train + n_test, 32, seed=seed)
    data = ds.images.transpose(0, 3, 1, 2).reshape(-1, 3072)
    names = [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]
    for i, name in enumerate(names):
        sl = slice(i * n_train, (i + 1) * n_train if i < 5 else None)
        with open(os.path.join(d, name), "wb") as fh:
            pickle.dump({b"batch_label": name.encode(), b"data": data[sl],
                         b"labels": [int(v) for v in ds.labels[sl]]}, fh)
    return str(root)


@pytest.fixture(scope="module")
def cifar_root(tmp_path_factory):
    return write_cifar10(tmp_path_factory.mktemp("cifar"))


def assert_same_dataset(got, want, n=None):
    """Equal labels and classes, and equal images through ``gather``."""
    assert len(got) == len(want)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.classes == want.classes
    idx = np.arange(len(want) if n is None else n)
    for g, w in zip(got.gather(idx), want.gather(idx)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("train", [True, False])
def test_cifar10_matches_jax(cifar_root, train):
    got = PIPE.get_dataset("cifar10", cifar_root, train)
    want = JPIPE.get_dataset("cifar10", cifar_root, train)
    assert got.images.shape == (160 if train else 40, 32, 32, 3)
    assert got.images.flags["C_CONTIGUOUS"] and got.labels.dtype == np.int32
    assert_same_dataset(got, want)
    assert got.classes[0] == "airplane" and len(got.classes) == 10


def test_cifar10_missing_batch_raises_as_jax(tmp_path):
    root = write_cifar10(tmp_path, n_train=2, n_test=2)
    os.remove(os.path.join(root, "cifar-10-batches-py", "data_batch_3"))
    with pytest.raises(FileNotFoundError) as got:
        PIPE.get_dataset("cifar10", root, True)
    with pytest.raises(FileNotFoundError) as want:
        JPIPE.get_dataset("cifar10", root, True)
    assert str(got.value) == str(want.value)
    assert "data_batch_3" in str(got.value)
    with pytest.raises(FileNotFoundError, match="test_batch"):
        PIPE.get_dataset("cifar10", str(tmp_path / "nowhere"), False)


def write_folder(root, split, classes=("alpha", "beta", "gamma"), n=3,
                 seed=0):
    """``root/split/<class>/<i>.png`` of mixed sizes and aspect ratios (and
    a stray text file that both loaders skip)."""
    rng = np.random.default_rng(seed)
    for ci, c in enumerate(classes):
        d = os.path.join(root, split, c)
        os.makedirs(d, exist_ok=True)
        for i in range(n):
            h, w = (40, 50) if i % 2 else (61, 37)
            Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                            ).save(os.path.join(d, f"{i}.png"))
        with open(os.path.join(d, "notes.txt"), "w") as fh:
            fh.write("not an image")


@pytest.mark.parametrize("name,split,train", [
    ("Imagenette", "train", True), ("Imagenette", "val", False),
    ("ImageNet", "validation", False), ("miniImagenet", "test", False),
    ("miniImagenet", "train", True)])
def test_folder_datasets_match_jax(tmp_path, name, split, train):
    write_folder(tmp_path, split)
    got = PIPE.get_dataset(name, str(tmp_path), train, image_size=32)
    want = JPIPE.get_dataset(name, str(tmp_path), train, image_size=32)
    assert isinstance(got, PIPE.FolderDataset)
    assert got.paths == want.paths
    assert all(os.sep + split + os.sep in p for p in got.paths)
    assert got.classes == ["alpha", "beta", "gamma"] and len(got) == 9
    assert_same_dataset(got, want)
    # lazy gather through batches, ragged last batch kept
    for (gi, gl), (wi, wl) in zip(
            PIPE.batches(got, np.arange(9), 4, shuffle=True, seed=1,
                         drop_remainder=False),
            JPIPE.batches(want, np.arange(9), 4, shuffle=True, seed=1,
                          drop_remainder=False)):
        assert gi.shape[1:] == (32, 32, 3)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)


def test_folder_split_preference_and_missing_split(tmp_path):
    """Eval takes ``val`` before ``validation`` before ``test``; a missing
    split raises the JAX package's error."""
    for split in ("test", "validation", "val"):
        write_folder(tmp_path, split, classes=(split,))
        got = PIPE.get_dataset("ImageNet", str(tmp_path), False)
        assert got.classes == [split]
        assert got.classes == JPIPE.get_dataset("ImageNet", str(tmp_path),
                                                False).classes
    with pytest.raises(FileNotFoundError) as got:
        PIPE.get_dataset("Imagenette", str(tmp_path), True)
    with pytest.raises(FileNotFoundError) as want:
        JPIPE.get_dataset("Imagenette", str(tmp_path), True)
    assert str(got.value) == str(want.value)
    os.makedirs(tmp_path / "train")
    with pytest.raises(FileNotFoundError, match="no class subdirectories"):
        PIPE.get_dataset("Imagenette", str(tmp_path), True)
    with pytest.raises(ValueError, match="unknown dataset"):
        PIPE.get_dataset("mnist", None, True)


def write_manifest(root, sizes, label_names=None, seed=0):
    rng = np.random.default_rng(seed)
    names = []
    for i, (h, w) in enumerate(sizes):
        p = os.path.join(root, f"img{i}.png")
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                        ).save(p)
        names.append(p)
    meta = {"image_names": names,
            "image_labels": [i % 3 for i in range(len(sizes))]}
    if label_names:
        meta["label_names"] = label_names
    path = os.path.join(root, "split.json")
    with open(path, "w") as fh:
        json.dump(meta, fh)
    return path


@pytest.mark.parametrize("label_names", [None, ["cat", "dog", "emu"]])
def test_manifest_matches_jax(tmp_path, label_names):
    path = write_manifest(tmp_path, [(24, 24)] * 5, label_names)
    got, want = (pkg.get_dataset(path, None, True) for pkg in (PIPE, JPIPE))
    assert isinstance(got, PIPE.ManifestDataset) and got.image_size is None
    assert got.classes == (label_names or ["0", "1", "2"])
    assert_same_dataset(got, want)
    # load_json_manifest with a size resizes every image (PIL bilinear)
    sized = [PIPE.load_json_manifest(path, 16),
             JPIPE.load_json_manifest(path, 16)]
    assert sized[0].gather(np.arange(2))[0].shape == (2, 16, 16, 3)
    assert_same_dataset(*sized)


def test_manifest_quirk_mixed_sizes_fail_to_stack(tmp_path):
    """JAX-package quirk, kept (ROADMAP Queue 3, open in both packages):
    ``get_dataset("*.json")`` opens the manifest without an image size
    (JAX pipeline.py:249), so a batch of images of mixed sizes cannot be
    stacked, in either package; a size given to ``load_json_manifest``
    would stack them."""
    path = write_manifest(tmp_path, [(24, 24), (30, 20), (24, 24)])
    for pkg in (PIPE, JPIPE):
        ds = pkg.get_dataset(path, None, True)
        assert ds.gather(np.asarray([0, 2]))[0].shape == (2, 24, 24, 3)
        with pytest.raises(ValueError, match="same shape"):
            ds.gather(np.arange(3))
        assert pkg.load_json_manifest(path, 24).gather(
            np.arange(3))[0].shape == (3, 24, 24, 3)


def test_folder_quirk_zooms_twice(tmp_path):
    """JAX-package quirk, kept (ROADMAP Queue 3, open in both packages):
    a folder image is resized to 1.15 P and center-cropped to P by the
    loader (JAX pipeline.py:72-86), then the eval ingest resizes P to
    int(1.15 P) and crops P again (JAX codec.py:265-280), so it reaches
    the DCT zoomed 1.15^2 where the reference zooms it 1.15.  The port's
    ingest of a folder batch is the double zoom, as the JAX package's
    is (float32 DCT: atol 1e-4, as tests/test_torch_codec.py)."""
    cfg = PC.CodecConfig(24, 4, 8)
    P = cfg.pixel_size
    write_folder(tmp_path, "train", n=2)
    ds = PIPE.get_dataset("Imagenette", str(tmp_path), True, image_size=P)
    imgs, _ = ds.gather(np.arange(len(ds)))
    assert imgs.shape[1:] == (P, P, 3)
    got = PC.dct_ingest(imgs, cfg)
    twice = PC._eval_resize_crop(torch.as_tensor(imgs), P)
    assert twice.shape[1:] == (P, P, 3)
    assert not torch.equal(twice, torch.as_tensor(imgs).float())
    np.testing.assert_array_equal(got, PC.dct_from_pixels(twice, cfg))
    assert (got - PC.dct_from_pixels(torch.as_tensor(imgs), cfg)
            ).abs().max() > 0.1
    want = JC.dct_ingest(jnp.asarray(imgs), JC.CodecConfig(24, 4, 8))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-4)


def test_lazy_loader_names_pillow_when_it_is_missing(tmp_path, monkeypatch):
    import builtins

    write_folder(tmp_path, "train", n=1)
    ds = PIPE.get_dataset("Imagenette", str(tmp_path), True, image_size=16)
    real_import = builtins.__import__

    def no_pil(name, *args, **kw):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("No module named 'PIL'")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(ImportError, match="Pillow"):
        ds.gather(np.arange(1))


TINY_TRAIN = ["--dataset", "cifar10", "--dct_status", "--model",
              "ResNet20qat", "--channels", "24", "--filter_size", "4",
              "--image_size_dct", "8", "--batch_size", "16",
              "--test_batch_size", "32", "--stop_epoch", "1", "--device",
              "cpu"]


def test_train_cifar10_epoch_writes_a_checkpoint_jax_reads(cifar_root,
                                                          tmp_path):
    """One tiny epoch of the trainer on the CIFAR-10 layout (160 training
    images: 144 train, 16 val; 40 test) writes the epoch's checkpoint
    ``0.tar``, which the JAX package's ``load_ckpt`` reads; its eval
    forward gives the port's classes, and its logits to float32 rounding
    (the classifier's sums in another order: rtol 1e-5)."""
    d = str(tmp_path / "ck")
    res = TRAIN.main(TINY_TRAIN + ["--train_aug", "--dataset_path",
                                   cifar_root, "--checkpoint_dir", d])
    assert res["steps"] == 144 // 16 and res["test_total"] == 40
    ck = JTRAIN.load_ckpt(os.path.join(d, "0.tar"))
    params, state = ck["state"]
    ds = PIPE.get_dataset("cifar10", cifar_root, False)
    x = PC.dct_ingest(ds.images[:8], PC.CodecConfig(24, 4, 8))
    spec = RES.build_spec("ResNet20qat", in_channels=24, img_size=8)
    with torch.no_grad():
        got = RES.QATResNet(params, state, spec).eval()(x)[1]
    jspec = JRES.build_spec("ResNet20qat", in_channels=24, img_size=8)
    want = JRES.forward(params, state, jnp.asarray(x.numpy()), jspec)[1]
    np.testing.assert_array_equal(got.argmax(1).numpy(),
                                  np.argmax(np.asarray(want), 1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_eval_cifar10_matches_jax_splits_and_simulate(cifar_root):
    """``homomorphic_eval`` on ``--dataset cifar10`` with the committed
    flagship: the JAX CLI's datasets and seeded split indices, and its
    simulate features bit for bit (the JAX module compiled from the port's
    calibration batch)."""
    from dct_cryptonets_tpu.fhe.runtime import compile_qat_model as jcompile

    cfg = HE.parse_args("homomorphic_eval", [
        "--dataset", "cifar10", "--dataset_path", cifar_root, "--dct_status",
        "--model", "ResNet20qat", "--channels", "24", "--filter_size", "4",
        "--image_size_dct", "16", "--checkpoint_path", CKPT,
        "--test_subset", "3", "--calib_batch_size", "8", "--fhe_mode",
        "simulate", "--device", "cpu"])
    s = HE.prepare(cfg)
    for got, train in ((s.trainset, True), (s.testset, False)):
        assert_same_dataset(got, JPIPE.get_dataset("cifar10", cifar_root,
                                                   train))
    np.testing.assert_array_equal(s.val_idx,
                                  JPIPE.train_val_split(160, 3)[1])
    np.testing.assert_array_equal(s.test_idx,
                                  JPIPE.train_val_split(40, 3)[1])
    x = s.ingest(s.testset.gather(s.test_idx)[0]).numpy()
    calib = s.ingest(s.trainset.gather(np.arange(8))[0]).numpy()
    jm = jcompile(s.params, s.state,
                  JRES.build_spec("ResNet20qat", in_channels=24, img_size=16),
                  n_bits=5, rounding_threshold_bits={"n_bits": 6,
                                                     "method": "exact"},
                  calib_data=calib)
    np.testing.assert_array_equal(s.module.forward(x, fhe="simulate"),
                                  np.asarray(jm.forward(x, fhe="simulate")))


def test_eval_cli_runs_on_cifar10(cifar_root, capsys):
    HE.main(["--dataset", "cifar10", "--dataset_path", cifar_root,
             "--dct_status", "--model", "ResNet20qat", "--channels", "24",
             "--filter_size", "4", "--image_size_dct", "16",
             "--checkpoint_path", CKPT, "--test_subset", "2",
             "--calib_batch_size", "8", "--fhe_mode", "simulate",
             "--device", "cpu"])
    out = capsys.readouterr().out
    assert "Loaded checkpoint" in out
    assert "ENCRYPTED test inference in SIMULATE mode on a subset of 2" in out
    assert "Done" in out


def read_trace(profile_dir):
    """The one trace file in ``profile_dir``, parsed."""
    files = glob.glob(os.path.join(profile_dir, "*.pt.trace.json"))
    assert len(files) == 1, os.listdir(profile_dir)
    with open(files[0]) as fh:
        return json.load(fh)


def test_profile_dir_writes_a_trace_of_each_cli(tmp_path, cifar_root):
    """``--profile_dir`` runs the CLI under ``torch.profiler`` (the CPU's
    operators here) and writes one trace file into the directory."""
    prof = str(tmp_path / "train_prof")
    TRAIN.main(TINY_TRAIN + ["--dataset_path", cifar_root,
                             "--checkpoint_dir", str(tmp_path / "ck"),
                             "--profile_dir", prof])
    names = {e.get("name") for e in read_trace(prof)["traceEvents"]}
    assert "aten::convolution" in names
    prof = str(tmp_path / "eval_prof")
    HE.main(["--dataset", "synthetic", "--dct_status", "--model",
             "ResNet20qat", "--channels", "24", "--filter_size", "4",
             "--image_size_dct", "8", "--test_subset", "1",
             "--calib_batch_size", "8", "--fhe_mode", "simulate",
             "--device", "cpu", "--profile_dir", prof])
    names = {e.get("name") for e in read_trace(prof)["traceEvents"]}
    assert "aten::convolution" in names
