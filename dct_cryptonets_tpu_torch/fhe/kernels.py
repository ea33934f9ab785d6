"""Hand-written Hopper kernels of the blind rotate's CMUX step.

Counterpart of ``dct_cryptonets_tpu.fhe.pallas_kernels``.  The fused
engine's CMUX step runs three kernels:

* :func:`rotate_decompose` (``csrc/rotate_decompose.cu``) — the front
  half: rotate, diff, gadget-decompose, byte-split;
* :func:`build_bigd_strips` (``csrc/bigd_strips.cu``) — the Toeplitz
  strip table of one CMUX step's bootstrapping-key bytes, K-major
  (``k_major=True``) for the external product;
* :func:`fused_external` (``csrc/fused_external.cu``) — the back half:
  the int8 tensor-core (``wgmma``) external product and its 64-bit
  accumulate.

The s2d engine runs :func:`rotate_decompose` in its sample-major layout,
two int8 GEMMs (``fhe/pbs.py``) and

* :func:`combine_accumulate` (``csrc/combine_accumulate.cu``) — the
  GEMMs' int32 byte-scale buckets recombined into the 64-bit accumulator.

:func:`rotate_diff` (``csrc/rotate_diff.cu``), X^a * acc - acc, has no
caller in either package.

Beside each kernel is its plain PyTorch version (``*_plain``): the same
function in the same layout.  A wrapper runs the plain version only for
tensors on the CPU; for a CUDA tensor it launches its kernel or raises.
Each wrapper counts its launches in ``<wrapper>.launches``.

The CUDA sources are compiled with ``nvcc`` for ``sm_90a`` into
``build/cuda/<source hash>/`` at the repository root on first use and
loaded with ``ctypes``.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

from . import torus as T
from .intmm import int8_matmul

I8 = torch.int8
I64 = torch.int64

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
SOURCES = ("rotate_decompose.cu", "bigd_strips.cu", "fused_external.cu",
           "combine_accumulate.cu", "rotate_diff.cu")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG_DIR), "build", "cuda")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the largest N whose row fits one block's shared memory: K1 stages N
# int64 (and byte planes), K2 2N bytes
K1_MAX_N, K2_MAX_N = 16384, 65536

_lib = None
build_log = ""


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path:
        return path
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC_DIR, name), "rb") as fh:
            h.update(name.encode() + fh.read())
    return h.hexdigest()[:16]


def build_kernels() -> float:
    """Compile (if needed) and load the kernel library; returns the seconds
    spent building (0 when an up-to-date build was found).  Each source is
    compiled by its own ``nvcc``, all started together, then linked."""
    global _lib, build_log
    if _lib is not None:
        return 0.0
    out_dir = os.path.join(BUILD_ROOT, _source_hash())
    so = os.path.join(out_dir, "libdctc_kernels.so")
    t = time.time()
    built = 0.0
    if not os.path.exists(so):
        os.makedirs(out_dir, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        nvcc = _nvcc()
        objs = [os.path.join(out_dir, f"{s}.{os.getpid()}.o") for s in SOURCES]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, os.path.join(CSRC_DIR, s)]
                for s, o in zip(SOURCES, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        logs = [p.communicate()[0] for p in procs]
        cmds.append([nvcc, "-shared", *NVCC_FLAGS[:2], "-o", tmp, *objs,
                     "-ldl"])
        if all(p.returncode == 0 for p in procs):
            res = subprocess.run(cmds[-1], capture_output=True, text=True)
            logs.append(res.stdout + res.stderr)
            rcs = [p.returncode for p in procs] + [res.returncode]
        else:
            rcs = [p.returncode for p in procs]
        build_log = "".join(" ".join(c) + "\n" + log
                            for c, log in zip(cmds, logs))
        with open(os.path.join(out_dir, "build.log"), "w") as fh:
            fh.write(build_log)
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
        if any(rcs):
            raise RuntimeError(f"nvcc failed ({rcs}):\n{build_log}")
        os.replace(tmp, so)
        built = time.time() - t
    else:
        log = os.path.join(out_dir, "build.log")
        if os.path.exists(log):
            with open(log) as fh:
                build_log = fh.read()
    lib = ctypes.CDLL(so)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.dctc_rotate_decompose.argtypes = [vp, vp, vp, vp] + [ci] * 7 + [vp]
    lib.dctc_bigd_strips.argtypes = [vp, vp, ci, ci, ci, vp]
    lib.dctc_fused_external.argtypes = [vp] * 5 + [ci] * 7 + [vp]
    lib.dctc_combine_accumulate.argtypes = [vp] * 4 + [ci] * 6 + [vp]
    lib.dctc_rotate_diff.argtypes = [vp] * 3 + [ci] * 3 + [vp]
    for fn in (lib.dctc_rotate_decompose, lib.dctc_bigd_strips,
               lib.dctc_fused_external, lib.dctc_combine_accumulate,
               lib.dctc_rotate_diff):
        fn.restype = ci
    _lib = lib
    return built


def _check_cuda(name: str, t: torch.Tensor, dtype, ndim: int, align: int):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: data pointer not {align}-byte aligned")


def _launch(fn, *args):
    err = fn(*args, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")


def _wrappers():
    return (rotate_decompose, build_bigd_strips, fused_external,
            combine_accumulate, rotate_diff)


def reset_launch_counts():
    for w in _wrappers():
        w.launches = 0


def launch_counts() -> dict:
    return {w.__name__: w.launches for w in _wrappers()}


# ---------------------------------------------------------------------------
# K1: rotate -> diff -> decompose -> byte split (CMUX front half)


def rotate_decompose_plain(acc: torch.Tensor, amounts: torch.Tensor,
                           blog: int, levels: int, plane_major: bool = True):
    """Plane-major: acc (J, M, N) int64, amounts (M,) in [0, 2N) ->
    (out0, out1): (J*levels, M, N) int8 low/high digit bytes, row
    j*levels + lev, digits most significant first.  Sample-major
    (``plane_major=False``, the s2d engine's layout): acc (M, J, N) ->
    (M, J*levels, N)."""
    if not plane_major:
        out = rotate_decompose_plain(acc.transpose(0, 1), amounts, blog,
                                     levels)
        return tuple(o.transpose(0, 1).contiguous() for o in out)
    J, M, N = acc.shape
    a = amounts.to(device=acc.device, dtype=I64)
    r = a & (N - 1)
    g = (a // N) & 1
    x = torch.arange(N, device=acc.device)
    src = (x[None, :] - r[:, None]) % N                    # (M, N)
    rot = torch.gather(acc, 2, src.expand(J, M, N))
    flip = (x[None, :] < r[:, None]) ^ (g[:, None] == 1)
    rot = torch.where(flip, -rot, rot)
    digits = T.decompose(rot - acc, blog, levels).to(I64)  # (lev, J, M, N)
    b0 = ((digits + 128) & 255) - 128
    b1 = ((((digits - b0) >> 8) + 128) & 255) - 128
    shape = (J * levels, M, N)
    return (b0.transpose(0, 1).reshape(shape).to(I8),
            b1.transpose(0, 1).reshape(shape).to(I8))


def rotate_decompose(acc: torch.Tensor, amounts: torch.Tensor, blog: int,
                     levels: int, plane_major: bool = True):
    """Kernel wrapper of :func:`rotate_decompose_plain`."""
    if acc.device.type == "cpu":
        return rotate_decompose_plain(acc, amounts, blog, levels, plane_major)
    _check_cuda("acc", acc, I64, 3, 8)
    J, M, N = acc.shape
    if not plane_major:
        M, J = J, M
    # the kernel stages a whole int64 row in shared memory (227 KB a block)
    if (N & (N - 1) or not 0 < N <= K1_MAX_N or not 0 < blog * levels <= 32
            or blog > 15 or not 0 < J < 2 ** 16 or M < 1):
        raise ValueError(f"unsupported J={J}, M={M}, N={N}, blog={blog}, "
                         f"levels={levels}")
    amounts = amounts.to(torch.int32)
    _check_cuda("amounts", amounts, torch.int32, 1, 4)
    if amounts.shape[0] != M or amounts.device != acc.device:
        raise ValueError("amounts must be (M,) on the accumulator's device")
    build_kernels()
    shape = (J * levels, M, N) if plane_major else (M, J * levels, N)
    out0 = torch.empty(shape, dtype=I8, device=acc.device)
    out1 = torch.empty_like(out0)
    _launch(_lib.dctc_rotate_decompose, acc.data_ptr(), amounts.data_ptr(),
            out0.data_ptr(), out1.data_ptr(), J, M, N, N.bit_length() - 1,
            blog, levels, int(plane_major))
    rotate_decompose.launches += 1
    return out0, out1


# ---------------------------------------------------------------------------
# K2: Toeplitz strip table


def _strip_index(N: int, device) -> torch.Tensor:
    tt = torch.arange(128, device=device)[:, None]
    x = torch.arange(2 * N - 128, device=device)[None, :]
    return (x - tt + N + 128) % (2 * N)                    # (128, 2N-128)


def build_bigd_strips_plain(dbl: torch.Tensor,
                            k_major: bool = False) -> torch.Tensor:
    """dbl (J, C, 2N) int8 doubled negacyclic byte rows ->
    (J, C, 128, 2N-128) int8 strips, strip[g, tt, x] =
    dbl[g, (x - tt + N + 128) mod 2N] (the TPU kernel's layout).

    ``k_major``: the strips of the reversed rows dbl[g, (-i) mod 2N], which
    hold each Toeplitz tile transposed, the contraction index along a row
    (:func:`toeplitz_from_strip`); :func:`fused_external` takes these."""
    J, C, twoN = dbl.shape
    idx = _strip_index(twoN // 2, dbl.device)
    if k_major:
        idx = (-idx) % twoN
    return dbl[:, :, idx]


def build_bigd_strips(dbl: torch.Tensor, k_major: bool = False) -> torch.Tensor:
    """Kernel wrapper of :func:`build_bigd_strips_plain`."""
    if dbl.device.type == "cpu":
        return build_bigd_strips_plain(dbl, k_major)
    _check_cuda("dbl", dbl, I8, 3, 16)
    J, C, twoN = dbl.shape
    N = twoN // 2
    # the kernel stages a whole 2N-byte row in shared memory
    if twoN % 2 or N % 128 or N & (N - 1) or N > K2_MAX_N or J * C < 1:
        raise ValueError(f"unsupported shape {tuple(dbl.shape)}")
    build_kernels()
    out = torch.empty((J, C, 128, twoN - 128), dtype=I8, device=dbl.device)
    _launch(_lib.dctc_bigd_strips, dbl.data_ptr(), out.data_ptr(), J * C, N,
            int(k_major))
    build_bigd_strips.launches += 1
    return out


# ---------------------------------------------------------------------------
# K3: external product + 64-bit accumulate (CMUX back half)


def bucket_pairs(L: int, drop: int, cross: int) -> dict:
    """Byte scale s -> [(u, vi), ...] of the kept (digit byte, key limb)
    pairs: s = u + vi + drop < 8 and u + vi >= cross."""
    out: dict = {}
    for u in range(2):
        for vi in range(L):
            s = u + vi + drop
            if s >= 8 or u + vi < cross:
                continue
            out.setdefault(s, []).append((u, vi))
    return out


def toeplitz_t_from_strips(strips: torch.Tensor) -> torch.Tensor:
    """(C, 128, 2N-128) K-major strips -> (N, C*N): the transposed (N, N)
    negacyclic Toeplitz matrix of each strip, side by side, contiguous.
    Rows [128 x0, 128 (x0+1)) of matrix c are
    strips[c, :, N - 128(x0+1) : 2N - 128(x0+1)]: one strided view of
    every window, reversed in x0 by one copy."""
    strips = strips.contiguous()
    C, _, W = strips.shape
    N = (W + 128) // 2
    windows = strips.as_strided((N // 128, 128, C, N), (128, W, 128 * W, 1),
                                strips.storage_offset())
    return windows.flip(0).reshape(N, C * N)


def toeplitz_from_strip(strip: torch.Tensor) -> torch.Tensor:
    """(128, 2N-128) K-major strip -> (N, N) negacyclic Toeplitz matrix
    T[k, x] = dbl[(x - k) mod 2N] (a column-major view)."""
    return toeplitz_t_from_strips(strip[None]).t()


def fused_external_plain(dB0: torch.Tensor, dB1: torch.Tensor,
                         bigd: torch.Tensor, acc: torch.Tensor, drop: int,
                         cross: int = 0) -> torch.Tensor:
    """acc + external product.

    dB0/dB1: (rows, M, N) int8 digit-byte planes (:func:`rotate_decompose`);
    bigd: (J, L*rows, 128, 2N-128) int8 K-major strips
    (``build_bigd_strips(..., k_major=True)``), combo vi*rows + r;
    acc: (J, M, N) int64 plane-major.  Returns the updated (J, M, N).
    """
    J, M, N = acc.shape
    rows = dB0.shape[0]
    L = bigd.shape[1] // rows
    assert L == 8 - drop, (L, drop)
    dB = (dB0, dB1)
    out = acc.clone()
    for j in range(J):
        for s, pairs in sorted(bucket_pairs(L, drop, cross).items()):
            a = torch.cat([dB[u][r] for u, vi in pairs for r in range(rows)],
                          dim=1)
            # the Toeplitz operand built column-major, the layout the
            # card's int8 GEMM runs fastest on (fhe/intmm.py)
            combos = [vi * rows + r for u, vi in pairs for r in range(rows)]
            bt = toeplitz_t_from_strips(bigd[j, combos])
            out[j] += int8_matmul(a, bt.t()).to(I64) << (8 * s)
    return out


def fused_external(dB0: torch.Tensor, dB1: torch.Tensor, bigd: torch.Tensor,
                   acc: torch.Tensor, drop: int,
                   cross: int = 0) -> torch.Tensor:
    """Kernel wrapper of :func:`fused_external_plain`."""
    if acc.device.type == "cpu":
        return fused_external_plain(dB0, dB1, bigd, acc, drop, cross)
    _check_cuda("acc", acc, I64, 3, 16)
    J, M, N = acc.shape
    rows = dB0.shape[0]
    for name, t in (("dB0", dB0), ("dB1", dB1)):
        _check_cuda(name, t, I8, 3, 16)
        if tuple(t.shape) != (rows, M, N):
            raise ValueError(f"{name}: expected {(rows, M, N)}, "
                             f"got {tuple(t.shape)}")
    _check_cuda("bigd", bigd, I8, 4, 16)
    L = 8 - drop
    if tuple(bigd.shape) != (J, L * rows, 128, 2 * N - 128):
        raise ValueError(f"bigd: expected {(J, L * rows, 128, 2 * N - 128)}, "
                         f"got {tuple(bigd.shape)}")
    if N % 256 or not 0 <= drop < 8 or cross < 0:
        raise ValueError(f"unsupported N={N}, drop={drop}, cross={cross}")
    build_kernels()
    out = torch.empty_like(acc)
    _launch(_lib.dctc_fused_external, dB0.data_ptr(), dB1.data_ptr(),
            bigd.data_ptr(), acc.data_ptr(), out.data_ptr(), J, M, N, rows,
            L, drop, cross)
    fused_external.launches += 1
    return out


# ---------------------------------------------------------------------------
# K4: recombine the s2d external product's byte buckets (s2d back half)


def combine_accumulate_plain(o0: torch.Tensor, o1: torch.Tensor,
                             acc: torch.Tensor, drop: int,
                             cross: int = 0) -> torch.Tensor:
    """acc + sum_s bucket_s * 2^(8s) (mod 2^64).

    o0/o1: (M, J*L, N) int32 external products of the low/high digit
    bytes, channel j*L + vi for key limb vi + drop; acc: (M, J, N) int64.
    bucket_s sums, in int32, the terms of the (u, vi) pairs of
    :func:`bucket_pairs`.  Returns the updated (M, J, N)."""
    M, J, N = acc.shape
    L = o0.shape[1] // J
    o = (o0.view(M, J, L, N), o1.view(M, J, L, N))
    out = acc.clone()
    for s, pairs in sorted(bucket_pairs(L, drop, cross).items()):
        bucket = sum(o[u][:, :, vi] for u, vi in pairs)
        out += bucket.to(I64) << (8 * s)
    return out


def combine_accumulate(o0: torch.Tensor, o1: torch.Tensor, acc: torch.Tensor,
                       drop: int, cross: int = 0) -> torch.Tensor:
    """Kernel wrapper of :func:`combine_accumulate_plain`."""
    if acc.device.type == "cpu":
        return combine_accumulate_plain(o0, o1, acc, drop, cross)
    _check_cuda("acc", acc, I64, 3, 8)
    M, J, N = acc.shape
    L = o0.shape[1] // J
    for name, t in (("o0", o0), ("o1", o1)):
        _check_cuda(name, t, torch.int32, 3, 4)
        if tuple(t.shape) != (M, J * L, N):
            raise ValueError(f"{name}: expected {(M, J * L, N)}, "
                             f"got {tuple(t.shape)}")
    if N & (N - 1) or not 0 <= drop < 8 or cross < 0:
        raise ValueError(f"unsupported N={N}, drop={drop}, cross={cross}")
    build_kernels()
    out = torch.empty_like(acc)
    _launch(_lib.dctc_combine_accumulate, o0.data_ptr(), o1.data_ptr(),
            acc.data_ptr(), out.data_ptr(), M, J, N.bit_length() - 1, L,
            drop, cross)
    combine_accumulate.launches += 1
    return out


# ---------------------------------------------------------------------------
# K5: negacyclic rotate-and-diff (no caller in either package)


def rotate_diff_plain(acc: torch.Tensor, amounts: torch.Tensor) -> torch.Tensor:
    """X^a * acc - acc for acc (M, J, N) int64 and amounts (M,) in
    [0, 2N)."""
    from .pbs import negacyclic_rotate   # pbs imports this module
    return negacyclic_rotate(acc, amounts) - acc


def rotate_diff(acc: torch.Tensor, amounts: torch.Tensor) -> torch.Tensor:
    """Kernel wrapper of :func:`rotate_diff_plain`."""
    if acc.device.type == "cpu":
        return rotate_diff_plain(acc, amounts)
    _check_cuda("acc", acc, I64, 3, 8)
    M, J, N = acc.shape
    if N & (N - 1):
        raise ValueError(f"unsupported N={N}")
    amounts = amounts.to(torch.int32)
    _check_cuda("amounts", amounts, torch.int32, 1, 4)
    if amounts.shape[0] != M or amounts.device != acc.device:
        raise ValueError("amounts must be (M,) on the accumulator's device")
    build_kernels()
    out = torch.empty_like(acc)
    _launch(_lib.dctc_rotate_diff, acc.data_ptr(), amounts.data_ptr(),
            out.data_ptr(), M, J, N.bit_length() - 1)
    rotate_diff.launches += 1
    return out


reset_launch_counts()
