"""ctypes binding of the native C++ host codec (``native/dctcodec.cpp``),
counterpart of ``dct_cryptonets_tpu.data.native`` on the port's
``CodecConfig`` and tables.

The host codec computes what ``data.codec.dct_from_pixels`` computes, on
the CPU in C++ threads, for hosts that preprocess beside the device.  The
source is compiled with ``g++`` at first use, with ``native/Makefile``'s
flags, into ``build/native/<hash>/`` at the repository root; the hash
covers the source, the flags and the compiler's reading of
``-march=native``, so a build made for another CPU is never loaded.
Nothing is written into ``native/`` and its committed library is never
loaded.  A failed build or load raises; only :func:`native_available`
answers ``False``.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np

from .codec import CodecConfig

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(_REPO, "native", "dctcodec.cpp")
BUILD_ROOT = os.path.join(_REPO, "build", "native")
# native/Makefile's CXXFLAGS and LDFLAGS
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
             "-shared", "-pthread")

_lib = None


def _cxx() -> str:
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError("no C++ compiler (g++) found: the native codec "
                           "cannot be built")
    return path


def _build_dir(cxx: str) -> str:
    """``BUILD_ROOT/<hash>`` of the source, the flags and the target the
    compiler resolves ``-march=native`` to on this CPU."""
    target = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                            capture_output=True, text=True, check=True).stdout
    h = hashlib.sha256(" ".join((cxx,) + CXX_FLAGS).encode() + target.encode())
    with open(SOURCE, "rb") as fh:
        h.update(fh.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16])


def library_path() -> str:
    """Build the codec library if needed and return its path."""
    cxx = _cxx()
    out_dir = _build_dir(cxx)
    so = os.path.join(out_dir, "libdctcodec.so")
    if not os.path.exists(so):
        os.makedirs(out_dir, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        res = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE],
                             capture_output=True, text=True)
        if res.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(f"building {SOURCE} failed "
                               f"({res.returncode}):\n{res.stderr}")
        os.replace(tmp, so)
    return so


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(library_path())
    u8p = ctypes.POINTER(ctypes.c_uint8)
    ip, fp, ci = (ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float),
                  ctypes.c_int)
    lib.dct_ingest_batch.argtypes = [u8p, ci, ci, ci, ip, ci, ip, ci, ip, ci,
                                     fp, fp, fp, ci]
    lib.dct_ingest_batch.restype = None
    lib.blockwise_dct_plane.argtypes = [fp, ci, ci, ci, ci, fp]
    lib.blockwise_dct_plane.restype = None
    _lib = lib
    return lib


def _iptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def native_available() -> bool:
    """Whether the codec builds and loads here."""
    try:
        _load()
        return True
    except (OSError, RuntimeError, subprocess.CalledProcessError):
        return False


def dct_ingest_native(images: np.ndarray, cfg: CodecConfig,
                      num_threads: int | None = None) -> np.ndarray:
    """uint8 RGB (B, P, P, 3) center-cropped batch, P = ``cfg.pixel_size``
    -> float32 (B, S, S, C): ``codec.dct_from_pixels`` on the host."""
    lib = _load()
    images = np.ascontiguousarray(images, np.uint8)
    if images.ndim != 4 or images.shape[1:] != (cfg.pixel_size,
                                                cfg.pixel_size, 3):
        raise ValueError(f"expected (B, {cfg.pixel_size}, {cfg.pixel_size}, "
                         f"3) images, got {images.shape}")
    B = images.shape[0]
    iy, icb, icr = (np.ascontiguousarray(i, np.int32) for i in cfg.subset())
    mean, std = (np.ascontiguousarray(a, np.float32) for a in cfg.stats())
    C = len(iy) + len(icb) + len(icr)
    S = cfg.image_size_dct
    out = np.empty((B, S, S, C), np.float32)
    nt = num_threads or min(os.cpu_count() or 1, 8)
    lib.dct_ingest_batch(
        images.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), B,
        cfg.filter_size, S, _iptr(iy), len(iy), _iptr(icb), len(icb),
        _iptr(icr), len(icr), _fptr(mean), _fptr(std), _fptr(out), nt)
    return out


def blockwise_dct_native(plane: np.ndarray, fs: int,
                         round_int: bool = False) -> np.ndarray:
    """(h, w) raw 0..255 pixels -> (h/fs, w/fs, fs*fs) orthonormal DCT
    coefficients; the level shift (-128) is applied inside."""
    lib = _load()
    plane = np.ascontiguousarray(plane, np.float32)
    h, w = plane.shape
    if h % fs or w % fs:
        raise ValueError(f"plane {plane.shape} is not a whole number of "
                         f"{fs} x {fs} blocks")
    out = np.empty((h // fs, w // fs, fs * fs), np.float32)
    lib.blockwise_dct_plane(_fptr(plane), h, w, fs, int(round_int), _fptr(out))
    return out
