"""The port's binding of the native host codec (``data/native.py``): its own
build of ``native/dctcodec.cpp`` into ``build/native/``, its output against
the JAX package's binding and against the port's ``dct_from_pixels``, and
a build that fails.

Tolerance against ``dct_from_pixels`` is ``tests/test_native_codec.py``'s:
the C++ color conversion runs in double, the device codec's in float32, so
a pixel on a .5 tie may round one level apart and move a few coefficients
(99 % of elements within 5e-2, none off by 2 or more).  Against the JAX
binding, which runs the same source, the output is equal bit for bit."""
import os

import numpy as np
import pytest
import torch

from dct_cryptonets_tpu.data import native as JNATIVE
from dct_cryptonets_tpu.data.codec import CodecConfig as JCodecConfig
from dct_cryptonets_tpu.ops.dct import blockwise_dct2 as j_blockwise_dct2
from dct_cryptonets_tpu_torch.data import native as NATIVE
from dct_cryptonets_tpu_torch.data.codec import CodecConfig, dct_from_pixels

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def native_dir_state():
    d = os.path.join(REPO, "native")
    return {f: os.stat(os.path.join(d, f)).st_mtime_ns
            for f in sorted(os.listdir(d))}


def test_build_lands_in_build_native_and_leaves_native_alone():
    before = native_dir_state()
    so = NATIVE.library_path()
    assert os.path.dirname(os.path.dirname(so)) == os.path.join(
        REPO, "build", "native")
    assert os.path.basename(so) == "libdctcodec.so" and os.path.exists(so)
    assert NATIVE.native_available()
    assert NATIVE._load()._name == so
    assert native_dir_state() == before
    assert NATIVE.library_path() == so          # found, not rebuilt


@pytest.mark.parametrize("fs,h,w", [(4, 32, 32), (8, 16, 24), (4, 8, 12)])
@pytest.mark.parametrize("round_int", [False, True])
def test_blockwise_dct_matches_jax(fs, h, w, round_int):
    plane = np.random.default_rng(fs + h).integers(0, 256, (h, w)).astype(
        np.float32)
    got = NATIVE.blockwise_dct_native(plane, fs, round_int)
    assert got.shape == (h // fs, w // fs, fs * fs)
    np.testing.assert_array_equal(
        got, JNATIVE.blockwise_dct_native(plane, fs, round_int))
    if not round_int:
        np.testing.assert_allclose(got, np.asarray(j_blockwise_dct2(
            plane, fs)), atol=1e-2)


@pytest.mark.parametrize("fs,S,ch", [(4, 16, 24), (8, 8, 24), (8, 56, 64),
                                     (4, 8, 48)])
def test_ingest_matches_jax_binding_and_device_codec(fs, S, ch):
    cfg = CodecConfig(channels=ch, filter_size=fs, image_size_dct=S)
    imgs = np.random.default_rng(1).integers(
        0, 256, (3, cfg.pixel_size, cfg.pixel_size, 3)).astype(np.uint8)
    got = NATIVE.dct_ingest_native(imgs, cfg)
    assert got.shape == (3, S, S, ch) and got.dtype == np.float32
    np.testing.assert_array_equal(got, JNATIVE.dct_ingest_native(
        imgs, JCodecConfig(channels=ch, filter_size=fs, image_size_dct=S)))
    np.testing.assert_array_equal(got, NATIVE.dct_ingest_native(
        imgs, cfg, num_threads=1))
    diff = np.abs(got - dct_from_pixels(torch.as_tensor(imgs), cfg).numpy())
    assert (diff < 5e-2).mean() > 0.99 and diff.max() < 2.0


def test_ingest_refuses_images_of_another_size():
    cfg = CodecConfig(24, 4, 16)
    with pytest.raises(ValueError, match="64, 64, 3"):
        NATIVE.dct_ingest_native(np.zeros((2, 32, 32, 3), np.uint8), cfg)
    with pytest.raises(ValueError, match="blocks"):
        NATIVE.blockwise_dct_native(np.zeros((10, 8), np.float32), 4)


def test_a_broken_build_raises(tmp_path, monkeypatch):
    """A source that does not compile raises with the compiler's message;
    only ``native_available`` answers False, and nothing is left in the
    build directory but the empty hash directory."""
    broken = tmp_path / "dctcodec.cpp"
    broken.write_text("extern \"C\" void dct_ingest_batch( {\n")
    monkeypatch.setattr(NATIVE, "SOURCE", str(broken))
    monkeypatch.setattr(NATIVE, "BUILD_ROOT", str(tmp_path / "build"))
    monkeypatch.setattr(NATIVE, "_lib", None)
    with pytest.raises(RuntimeError, match="building .*dctcodec.cpp failed"):
        NATIVE.dct_ingest_native(np.zeros((1, 64, 64, 3), np.uint8),
                                 CodecConfig(24, 4, 16))
    assert not NATIVE.native_available()
    (hash_dir,) = os.listdir(tmp_path / "build")
    assert os.listdir(tmp_path / "build" / hash_dir) == []
