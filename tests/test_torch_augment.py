"""The port's train-path ingest and the digits set against the JAX package.

The port splits each random stage into a draw and a deterministic part
(``codec.draw_train``, ``codec.augment``).  Here the deterministic parts are
fed the draws that the JAX functions make from a key (re-derived with
``jax.random`` as the JAX code derives them) and held against the JAX
``_random_resized_crop``, ``_image_jitter``, ``dct_ingest_train``,
``rgb_ingest_train`` and ``rgb_ingest``.

Tolerances: the crop's per-axis weights are bit for bit against JAX's
weight function; the crop and the jitter sum float32 terms in another
order, a few ulps of 255 (ulp 1.5e-5): atol 1e-4.
The rounded pixels equal the JAX stages' bit for bit.  The jitted JAX
``dct_ingest_train`` rounds 1-2 % of its pixels otherwise than its own
stages run one by one, so the DCT is held against the JAX stage fed the
port's pixels, to atol 1e-4 as the eval path is
(``tests/test_torch_codec.py``: float32 DCT einsums in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.image.scale import _fill_triangle_kernel, compute_weight_mat

from dct_cryptonets_tpu.data import codec as JC
from dct_cryptonets_tpu.data import pipeline as JPIPE
from dct_cryptonets_tpu_torch.data import codec as PC
from dct_cryptonets_tpu_torch.data import pipeline as PIPE

torch.set_num_threads(1)


def jax_crop_box(key, B, H, W, scale=(0.08, 1.0),
                 ratio=(3.0 / 4.0, 4.0 / 3.0)):
    """(h, w, top, left) as the JAX ``_random_resized_crop`` draws them."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    area = jax.random.uniform(k1, (B,), minval=scale[0],
                              maxval=scale[1]) * (H * W)
    log_r = jax.random.uniform(k2, (B,), minval=np.log(ratio[0]),
                               maxval=np.log(ratio[1]))
    r = jnp.exp(log_r)
    w = jnp.clip(jnp.sqrt(area * r), 1.0, W)
    h = jnp.clip(jnp.sqrt(area / r), 1.0, H)
    top = jax.random.uniform(k3, (B,)) * (H - h)
    left = jax.random.uniform(k4, (B,)) * (W - w)
    return tuple(torch.as_tensor(np.array(a)) for a in (h, w, top, left))


def jax_jitter_factors(key, B, j=0.4):
    """(B, 3) brightness, contrast, color factors of ``_image_jitter``."""
    return torch.as_tensor(np.stack([np.array(
        1.0 + j * (jax.random.uniform(k, (B, 1, 1, 1)) * 2 - 1)).reshape(B)
        for k in jax.random.split(key, 3)], 1))


def jax_train_draws(key, B, H, W, j=0.4) -> PC.TrainDraws:
    """The draws of ``dct_ingest_train`` / ``rgb_ingest_train`` for key."""
    kc, kj, kf = jax.random.split(key, 3)
    flip = np.array(jax.random.bernoulli(kf, 0.5, (B, 1, 1, 1))).reshape(B)
    return PC.TrainDraws(jax_crop_box(kc, B, H, W),
                         jax_jitter_factors(kj, B, j), torch.as_tensor(flip))


def images(seed, B, H, W):
    return np.random.default_rng(seed).integers(0, 256, (B, H, W, 3)).astype(
        np.uint8)


@pytest.mark.parametrize("B,H,W,P", [(6, 37, 29, 32), (4, 64, 64, 64),
                                     (3, 32, 32, 36)])
def test_resized_crop_matches_jax(B, H, W, P):
    x = images(P, B, H, W)
    key = jax.random.key(P)
    h, w, top, left = jax_crop_box(key, B, H, W)
    want = np.asarray(JC._random_resized_crop(key, jnp.asarray(x), P))
    got = PC.resized_crop(torch.as_tensor(x), h, w, top, left, P)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    for i in range(B):      # the per-axis weights, bit for bit
        for n, size, t in ((H, h[i], top[i]), (W, w[i], left[i])):
            s = torch.tensor(float(P)) / size
            jw = compute_weight_mat(n, P, jnp.asarray(s.numpy()),
                                    jnp.asarray((-t * s).numpy()),
                                    _fill_triangle_kernel, False)
            pw = PC._crop_weights(n, P, s[None], (-t * s)[None])[0]
            np.testing.assert_array_equal(pw.numpy(), np.asarray(jw).T)


def test_image_jitter_matches_jax():
    B = 5
    x = images(1, B, 24, 24).astype(np.float32)
    key = jax.random.key(9)
    want = np.asarray(JC._image_jitter(key, jnp.asarray(x)))
    got = PC.image_jitter(torch.as_tensor(x), jax_jitter_factors(key, B))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def jax_pixels(key, x, P, j=0.4):
    """The JAX train path's rounded pixels (its own stages, in order)."""
    kc, kj, kf = jax.random.split(key, 3)
    y = JC._random_resized_crop(kc, jnp.asarray(x), P)
    y = JC._image_jitter(kj, y, brightness=j, contrast=j, color=j)
    flip = jax.random.bernoulli(kf, 0.5, (x.shape[0], 1, 1, 1))
    y = jnp.where(flip, y[:, :, ::-1, :], y)
    return np.asarray(jnp.clip(jnp.round(y), 0, 255))


@pytest.mark.parametrize("fs,S,H", [(4, 16, 64), (4, 8, 40), (8, 4, 32)])
def test_dct_ingest_train_matches_jax(fs, S, H):
    cfg, jcfg = PC.CodecConfig(24, fs, S), JC.CodecConfig(24, fs, S)
    B = 6
    x = images(fs + S, B, H, H)
    key = jax.random.key(S)
    draws = jax_train_draws(key, B, H, H)
    px = PC.augment(torch.as_tensor(x), draws, cfg.pixel_size)
    np.testing.assert_array_equal(px.numpy(), jax_pixels(key, x,
                                                         cfg.pixel_size))
    got = PC.dct_from_pixels(px, cfg)
    want = np.asarray(JC.dct_from_pixels(jnp.asarray(px.numpy()), jcfg))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("dataset", ["cifar10", "digits"])
def test_rgb_ingest_matches_jax(dataset):
    B, size = 5, 32
    x = images(3, B, 40, 40)
    key = jax.random.key(4)
    j = PC.rgb_jitter_param(dataset)
    assert j == JC.rgb_jitter_param(dataset)
    draws = jax_train_draws(key, B, 40, 40, j)
    px = PC.augment(torch.as_tensor(x), draws, size)
    np.testing.assert_array_equal(px.numpy(), jax_pixels(key, x, size, j))
    got = PC.rgb_normalize(px, dataset)
    want = JC.rgb_normalize(jnp.asarray(px.numpy()), dataset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    got = PC.rgb_ingest(torch.as_tensor(x), size, dataset)
    want = JC.rgb_ingest(jnp.asarray(x), size, dataset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_train_draws_follow_their_distributions():
    """RandomResizedCrop's box (area share in [0.08, 1], aspect in [3/4,
    4/3], inside the image), jitter factors in 1 +- 0.4, fair flips; one
    seed, one set of draws."""
    B, H, W = 4096, 64, 48
    d = PC.draw_train(torch.Generator().manual_seed(0), B, H, W)
    h, w, top, left = d.crop
    assert (h >= 1).all() and (w >= 1).all() and (h <= H).all()
    assert (top >= 0).all() and (top + h <= H + 1e-3).all()
    assert (left >= 0).all() and (left + w <= W + 1e-3).all()
    inside = (h < H) & (w < W)
    share = (h * w / (H * W))[inside]
    assert share.min() >= 0.08 - 1e-5 and share.max() <= 1 + 1e-5
    ratio = (w / h)[inside]
    assert ratio.min() >= 0.75 - 1e-5 and ratio.max() <= 4 / 3 + 1e-5
    assert abs(d.jitter.mean() - 1) < 0.02 and (d.jitter - 1).abs().max() \
        <= 0.4
    assert abs(d.flip.float().mean() - 0.5) < 0.03
    again = PC.draw_train(torch.Generator().manual_seed(0), B, H, W)
    assert all(torch.equal(a, b) for a, b in zip(d.crop, again.crop))


@pytest.mark.parametrize("train", [True, False])
def test_digits_match_jax_and_sklearn(train):
    """The committed CSV parses to sklearn's ``load_digits``; the loader
    gives the JAX package's images, labels and split."""
    from sklearn.datasets import load_digits
    got = PIPE.load_digits_dataset(train, 64)
    want = JPIPE.load_digits_dataset(train, 64)
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.labels.dtype == want.labels.dtype and got.classes == \
        want.classes
    assert len(got) == (1437 if train else 360)
    if train:
        import gzip
        with gzip.open(PIPE.DIGITS_CSV, "rt") as fh:
            data = np.loadtxt(fh, delimiter=",")
        d = load_digits()
        np.testing.assert_array_equal(data[:, :-1].reshape(-1, 8, 8),
                                      d.images)
        np.testing.assert_array_equal(data[:, -1].astype(int), d.target)


def test_flagship_digits_counts_match_jax():
    """The committed flagship over the CLI's 359 digits test images on
    the CPU: the port's clear model gives the JAX package's classes, and
    its compiled circuit (calibration on the first 64 training images,
    exact rounding, n_bits 5, threshold 6) simulates the JAX package's
    features bit for bit: 329 / 359 clear, 322 / 359 simulate."""
    import os

    from dct_cryptonets_tpu.fhe.runtime import compile_qat_model as jcompile
    from dct_cryptonets_tpu.models import resnet as JRES
    from dct_cryptonets_tpu_torch import homomorphic_eval as HE

    ckpt = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "checkpoints", "digits_flagship", "best.tar")
    s = HE.prepare(HE.parse_args("homomorphic_eval", [
        "--dataset", "digits", "--dct_status", "--model", "ResNet20qat",
        "--channels", "24", "--filter_size", "4", "--image_size_dct", "16",
        "--checkpoint_path", ckpt, "--test_subset", "359",
        "--device", "cpu"]))
    assert len(s.test_idx) == 359
    x = s.ingest(s.testset.images[s.test_idx])
    labels = s.testset.labels[s.test_idx]
    with torch.no_grad():
        got = s.model(x)[1].argmax(1).numpy()
    jspec = JRES.build_spec("ResNet20qat", in_channels=24, img_size=16)
    _, logits, _ = JRES.forward(s.params, s.state, jnp.asarray(x.numpy()),
                                jspec)
    np.testing.assert_array_equal(got, np.argmax(np.asarray(logits), 1))
    assert (got == labels).sum() == 329
    calib = s.ingest(s.trainset.images[:64]).numpy()
    jm = jcompile(s.params, s.state, jspec, n_bits=5,
                  rounding_threshold_bits={"n_bits": 6, "method": "exact"},
                  calib_data=calib)
    feats = s.module.forward(x.numpy(), fhe="simulate")
    np.testing.assert_array_equal(feats, np.asarray(jm.forward(
        x.numpy(), fhe="simulate")))
    clf = s.params["classifier"]
    assert (np.argmax(feats @ clf["w"] + clf["b"], 1) == labels).sum() == 322
