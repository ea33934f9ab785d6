"""Batched TFHE server-side operations: keyswitch, blind rotate, sample
extract, programmable bootstrapping and exact-rounding bit clearing.

Counterpart of ``dct_cryptonets_tpu.fhe.pbs``.  Ciphertexts are ``int64``
tensors (``fhe.torus``).  The blind rotate's CMUX step runs one of two of
the TPU package's engines, step for step:

* the fused engine: the K-major Toeplitz strips of the step's key bytes
  (:func:`~.kernels.build_bigd_strips`), the front half
  (:func:`~.kernels.rotate_decompose`) and the int8 external product with
  its 64-bit accumulate (:func:`~.kernels.fused_external`), on a
  plane-major (k+1, M, N) accumulator;
* the s2d engine: the front half in its sample-major layout, the external
  product as one int8 GEMM per digit byte against the step's Toeplitz
  operand (:func:`expand_bsk_kernel_s2d`, :func:`conv_external_s2d`) and
  the 64-bit recombine (:func:`~.kernels.combine_accumulate`), on a
  sample-major (M, k+1, N) accumulator.

``engine`` picks the engine and who computes its kernels: ``"kernel"`` and
``"s2d"`` launch the hand-written CUDA kernels (``"kernel"`` is the
default for CUDA tensors; both raise on the CPU), ``"plain"`` and
``"s2d_plain"`` run their plain PyTorch versions (``"plain"`` is the
default for CPU tensors; they are the oracles the kernels are held
against on the card).  All four give the same ciphertexts bit for bit.
The TPU package's names are taken too: ``"fused"`` is ``"kernel"`` and
``"conv"`` is ``"plain"`` (the same products as the TPU package's XLA
convolutions, bit for bit).

The extraction lattice may carry a precomputed strip table
(:func:`with_precomputed_strips`, ``DeviceAuxKeys.bigd_bytes``): every
CMUX step's K-major strips, built once per key by one K2 launch, from
which each step hands its slice straight to K3.
"""
import os
from typing import NamedTuple

import numpy as np
import torch

from . import kernels as K
from . import torus as T
from .intmm import int8_matmul
from .keys import ServerKeyMaterial
from .params import TFHEParams

I8 = torch.int8
I64 = torch.int64


# ---------------------------------------------------------------------------
# device key preprocessing


class DeviceServerKeys(NamedTuple):
    """Server key material in byte-limb layout on one device."""
    # (n, (k+1)*l, k+1, 2N, 8) int8: balanced byte limbs of [bsk, -bsk]
    bsk_bytes: torch.Tensor
    # (kN * l_ks, n+1, 8) int8: balanced byte limbs of the keyswitch LWEs
    ksk_bytes: torch.Tensor


def u64_to_balanced_bytes(x: np.ndarray) -> np.ndarray:
    """uint64 array -> (..., 8) int8 balanced byte digits b_u in [-128, 128)
    with x == sum_u b_u * 256^u (mod 2^64); the top carry wraps."""
    r = x.astype(np.int64)
    out = np.empty((*x.shape, 8), np.int8)
    for u in range(8):
        b = ((r + 128) & 255) - 128
        out[..., u] = b.astype(np.int8)
        r = (r - b) >> 8
    return out


def _doubled_bytes(bsk: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        doubled = np.concatenate([bsk, -bsk], axis=-1)    # (..., 2N)
    return u64_to_balanced_bytes(doubled)


def _flat_ksk_bytes(ksk: np.ndarray) -> np.ndarray:
    s, l, d = ksk.shape
    return u64_to_balanced_bytes(ksk.reshape(s * l, d))


def preprocess_server_keys(sk: ServerKeyMaterial,
                           device=None) -> DeviceServerKeys:
    return DeviceServerKeys(
        torch.from_numpy(_doubled_bytes(sk.bsk)).to(device),
        torch.from_numpy(_flat_ksk_bytes(sk.ksk)).to(device))


class DeviceAuxKeys(NamedTuple):
    """Extraction key set (exact rounding) in byte-limb layout."""
    bsk_bytes: torch.Tensor       # (n_aux, (k+1)l, k+1, 2N_aux, 8) int8
    ksk_fwd_bytes: torch.Tensor   # (kN_main * l_ks_aux, n_aux + 1, 8) int8
    ksk_back_bytes: torch.Tensor  # (kN_aux * back_levels, kN_main + 1, 8)
    # optional precomputed K-major strip table at one drop
    # (with_precomputed_strips): (n_aux, k+1, L*rows, 128, 2N-128) int8
    bigd_bytes: torch.Tensor | None = None


def preprocess_aux_keys(ak, device=None) -> DeviceAuxKeys:
    """AuxServerKeyMaterial -> device byte-limb layout."""
    return DeviceAuxKeys(
        torch.from_numpy(_doubled_bytes(ak.bsk)).to(device),
        torch.from_numpy(_flat_ksk_bytes(ak.ksk_fwd)).to(device),
        torch.from_numpy(_flat_ksk_bytes(ak.ksk_back)).to(device))


# ---------------------------------------------------------------------------
# small helpers


def signed_byte_split(d: torch.Tensor, nbytes: int) -> torch.Tensor:
    """Integer tensor -> (nbytes, ...) int8 balanced byte digits:
    d = sum b_u * 256^u, b_u in [-128, 128)."""
    out = []
    r = d.to(I64)
    for _ in range(nbytes):
        b = ((r + 128) & 255) - 128
        out.append(b.to(I8))
        r = (r - b) >> 8
    return torch.stack(out, dim=0)


def _digit_bytes_count(base_log: int) -> int:
    return max(1, (base_log + 7) // 8)


def static_negacyclic_roll(p: torch.Tensor, r: int) -> torch.Tensor:
    """X^r * p for a static r in [0, 2N)."""
    N = p.shape[-1]
    r = r % (2 * N)
    upper = r >= N
    r = r % N
    out = torch.roll(p, r, dims=-1) if r else p
    if r == 0:
        return -out if upper else out
    flip = torch.arange(N, device=p.device) < r
    if upper:
        flip = ~flip
    return torch.where(flip, -out, out)


def negacyclic_rotate(p: torch.Tensor, amount: torch.Tensor) -> torch.Tensor:
    """X^amount * p with per-sample amounts, as index arithmetic.

    p: (M, ..., N); amount: (M,) integers in [0, 2N).
    (X^a p)[c] = p[(c - a) mod 2N], negated when that index is >= N.
    """
    N = p.shape[-1]
    a = amount.to(device=p.device, dtype=I64)
    a = a.reshape((-1,) + (1,) * (p.dim() - 1))
    idx = (torch.arange(N, device=p.device) - a) % (2 * N)
    negate = idx >= N
    idx = torch.where(negate, idx - N, idx).expand(p.shape)
    out = torch.gather(p, -1, idx)
    return torch.where(negate, -out, out)


# ---------------------------------------------------------------------------
# external product operands


def _bigd_rows(bsk_bytes_i: torch.Tensor, k: int, levels: int, N: int,
               drop_limbs: int) -> torch.Tensor:
    """(rows, k+1, 2N, 8) GGSW byte limbs -> (k+1, L*rows, 2N) doubled
    negacyclic byte rows, combo index vi * rows + r (key-limb-major)."""
    rows = (k + 1) * levels
    L = 8 - drop_limbs
    assert N % 128 == 0 and N >= 256
    kept = bsk_bytes_i[..., drop_limbs:]             # (rows, k+1, 2N, L)
    return kept.permute(1, 3, 0, 2).reshape(k + 1, L * rows,
                                            2 * N).contiguous()


def build_bigd(bsk_bytes_i: torch.Tensor, k: int, levels: int, N: int,
               drop_limbs: int) -> torch.Tensor:
    """GGSW byte limbs -> (k+1, L*rows, 128, 2N-128) Toeplitz strip table
    in the TPU kernel's layout (plain version; the CMUX step builds the
    K-major table with :func:`~.kernels.build_bigd_strips`)."""
    return K.build_bigd_strips_plain(
        _bigd_rows(bsk_bytes_i, k, levels, N, drop_limbs))


def precompute_bigd_strips(bsk_bytes: torch.Tensor, k: int, levels: int,
                           N: int, drop_limbs: int) -> torch.Tensor:
    """Every CMUX step's K-major Toeplitz strip table, built once.

    bsk_bytes: (n, rows, k+1, 2N, 8) int8.  Returns (n, k+1, L*rows, 128,
    2N-128) int8, L = 8 - drop_limbs: entry i is what the fused engine's
    CMUX step i builds from ``bsk_bytes[i]`` (:func:`_bigd_rows`, then
    K2 with ``k_major=True``), here from one K2 launch over all n*(k+1)
    key rows (the plain version for CPU tensors).  The TPU package's
    table holds the same strips in its own layout (each strip read
    backwards along both axes)."""
    n = bsk_bytes.shape[0]
    rows = (k + 1) * levels
    L = 8 - drop_limbs
    assert N % 128 == 0 and N >= 256
    kept = bsk_bytes[..., drop_limbs:]               # (n, rows, k+1, 2N, L)
    dbl = kept.permute(0, 2, 4, 1, 3).reshape(n * (k + 1), L * rows, 2 * N)
    strips = K.build_bigd_strips(dbl.contiguous(), k_major=True)
    return strips.view(n, k + 1, L * rows, 128, 2 * N - 128)


def strip_table_bytes(aux_keys: "DeviceAuxKeys", drop_limbs: int) -> int:
    """Bytes of the aux key's strip table at ``drop_limbs`` (the TPU
    package's size formula)."""
    n, rows, k1, twoN, _ = aux_keys.bsk_bytes.shape
    return n * k1 * (8 - drop_limbs) * rows * 128 * (twoN - 128)


def with_precomputed_strips(aux_keys: "DeviceAuxKeys", aux_params: TFHEParams,
                            drop_limbs: int,
                            max_bytes: int | None = None) -> "DeviceAuxKeys":
    """The aux keys with the precomputed strip table attached, under the
    TPU package's rules: no table for keys on the CPU (the plain engine
    builds each step's strips), for lattices with N > 512 (the main
    lattice's would hold ~25 GB) or for a table over ``max_bytes``
    (default ``DCTC_STRIP_TABLE_BYTES`` from the environment, else 2 GiB:
    the flagship's extraction table, 6.3 GB at drop 2, is left out)."""
    if aux_keys.bsk_bytes.device.type == "cpu" or aux_params.poly_size > 512:
        return aux_keys
    if max_bytes is None:
        max_bytes = int(os.environ.get("DCTC_STRIP_TABLE_BYTES",
                                       2 * 1024 ** 3))
    if strip_table_bytes(aux_keys, drop_limbs) > max_bytes:
        return aux_keys
    bigd = precompute_bigd_strips(
        aux_keys.bsk_bytes, aux_params.glwe_dim, aux_params.pbs_levels,
        aux_params.poly_size, drop_limbs)
    return aux_keys._replace(bigd_bytes=bigd)


def expand_bsk_kernel_s2d(bsk_bytes_i: torch.Tensor, k: int, levels: int,
                          N: int, drop_limbs: int) -> torch.Tensor:
    """GGSW byte limbs -> the s2d external product's int8 operand.

    bsk_bytes_i: (rows, k+1, 2N, 8) doubled negacyclic byte limbs.
    Returns (rows*N, (k+1)*L*N) int8, L = 8 - drop_limbs, the stacked
    negacyclic Toeplitz blocks with columns ordered (j, vi, c):

        B[r*N + t, (j*L + vi)*N + c] = b~[r, j, (c - t) mod 2N, drop + vi]

    The TPU package builds a stride-16 space-to-depth conv kernel here,
    whose only purpose is to fill the MXU's 128 lanes; the GPU's GEMM
    wants the Toeplitz matrix itself, so the same products come out of
    one int8 matrix product (:func:`conv_external_s2d`) in the conv's
    output layout.  B is column-major (the transpose of a contiguous
    matrix), the layout the card's int8 GEMM runs fastest.  It is 268 MB
    per step on an N=2048, k=1 lattice, so it is built per step.

    Built as one copy: with Rp[j, vi, r, q] = b~[r, j, (N - q) mod 2N,
    drop + vi], row c of block (j, vi, r) of B^T is the window
    Rp[..., N - c : 2N - c], so a strided view over Rp walks the rows
    in reverse and one flip writes them out.
    """
    rows = (k + 1) * levels
    L = 8 - drop_limbs
    q = (N - torch.arange(2 * N, device=bsk_bytes_i.device)) % (2 * N)
    rp = bsk_bytes_i[:, :, q, drop_limbs:].permute(1, 3, 0, 2).contiguous()
    hankel = rp.as_strided((k + 1, L, N, rows, N),
                           (L * rows * 2 * N, rows * 2 * N, 1, 2 * N, 1), 1)
    return hankel.flip(2).reshape((k + 1) * L * N, rows * N).t()


def conv_external_s2d(dB_u: torch.Tensor, kern: torch.Tensor, k: int, N: int,
                      drop_limbs: int) -> torch.Tensor:
    """One digit-byte plane through the s2d external product.

    dB_u: (M, rows, N) int8; kern from :func:`expand_bsk_kernel_s2d`.
    Returns (M, (k+1)*L, N) int32, channel j*L + vi: the TPU package's
    conv output layout."""
    M = dB_u.shape[0]
    return int8_matmul(dB_u.reshape(M, -1), kern).reshape(M, -1, N)


def cmux_accumulate_s2d(acc: torch.Tensor, a_i: torch.Tensor,
                        bsk_kern_i: torch.Tensor, params_tuple,
                        drop_limbs: int, cross: int = 0,
                        engine: str | None = None) -> torch.Tensor:
    """One s2d CMUX step (the TPU package's ``cmux_accumulate_pallas``):
    acc + GGSW_i x (X^{a_i} acc - acc) on a sample-major (M, k+1, N)
    accumulator.  bsk_kern_i must come from :func:`expand_bsk_kernel_s2d`;
    engine is ``"s2d"`` or ``"s2d_plain"`` (default: by device)."""
    blog, levels, k, N = params_tuple
    if engine is None:
        engine = "s2d" if acc.device.type == "cuda" else "s2d_plain"
    if engine not in _S2D:
        raise ValueError(f"engine {engine!r} is not an s2d engine")
    front, combine = _engine_fns(engine, acc.device)[1]
    dB0, dB1 = front(acc, a_i, blog, levels, plane_major=False)
    o0 = conv_external_s2d(dB0, bsk_kern_i, k, N, drop_limbs)
    o1 = conv_external_s2d(dB1, bsk_kern_i, k, N, drop_limbs)
    return combine(o0, o1, acc, drop_limbs, cross)


_ENGINES = {
    # fused engine: (strips, front half, back half)
    "kernel": (K.build_bigd_strips, K.rotate_decompose, K.fused_external),
    "plain": (K.build_bigd_strips_plain, K.rotate_decompose_plain,
              K.fused_external_plain),
    # s2d engine: (front half, recombine)
    "s2d": (K.rotate_decompose, K.combine_accumulate),
    "s2d_plain": (K.rotate_decompose_plain, K.combine_accumulate_plain),
}
_S2D = ("s2d", "s2d_plain")
_PLAIN_OF = {"kernel": "plain", "s2d": "s2d_plain"}   # CUDA-only engines
_TPU_NAMES = {"fused": "kernel", "conv": "plain"}


def _engine_fns(engine: str | None, device: torch.device):
    """-> (engine name, its functions); the TPU package's names map to
    the port's."""
    if engine is None:
        engine = "kernel" if device.type == "cuda" else "plain"
    name = _TPU_NAMES.get(engine, engine)
    if name not in _ENGINES:
        raise ValueError(f"unknown engine {engine!r}")
    if name in _PLAIN_OF and device.type != "cuda":
        raise ValueError(f"engine={engine!r} needs CUDA tensors (got "
                         f"{device}); use engine={_PLAIN_OF[name]!r} on "
                         "the CPU")
    return name, _ENGINES[name]


# ---------------------------------------------------------------------------
# blind rotate + sample extract + keyswitch


def mod_switch(ct: torch.Tensor, N: int) -> torch.Tensor:
    """Torus -> Z_{2N} with rounding: int64 in [0, 2N)."""
    bits = int(np.log2(2 * N))
    return T.round_shift_right(ct, 64 - bits) & (2 * N - 1)


def blind_rotate(test_poly: torch.Tensor, ct_a: torch.Tensor,
                 ct_b: torch.Tensor, bsk_bytes: torch.Tensor,
                 params: TFHEParams, drop_limbs: int = 0, cross: int = 0,
                 engine: str | None = None,
                 bigd_all: torch.Tensor | None = None) -> torch.Tensor:
    """Batched blind rotate.

    test_poly: (M, N) int64 per-sample lookup polynomials;
    ct_a: (M, n) mod-switched mask; ct_b: (M,) mod-switched body.
    cross: skip external-product byte pairs with digit byte + key limb
    index < cross.  engine: see the module docstring.  bigd_all: an
    optional strip table from :func:`precompute_bigd_strips` at the same
    ``drop_limbs``; the fused engine then feeds step i's slice to its
    external product instead of building the step's strips (the s2d
    engine ignores it, as the TPU package's does).  Returns GLWE
    accumulators (M, k+1, N) int64.
    """
    k, N, n = params.glwe_dim, params.poly_size, params.lwe_dim
    levels, blog = params.pbs_levels, params.pbs_base_log
    if _digit_bytes_count(blog) != 2:
        raise ValueError("the CMUX kernels take 2-byte gadget digits "
                         f"(pbs_base_log={blog})")
    engine, fns = _engine_fns(engine, test_poly.device)
    M = test_poly.shape[0]
    body = negacyclic_rotate(test_poly, (2 * N - ct_b) % (2 * N))
    a_cols = ct_a.t().to(torch.int32).contiguous()   # (n, M)
    if engine in _S2D:
        # acc init, sample-major (M, k+1, N): mask = 0, body = X^{-b} * test
        acc = T.zeros((M, k + 1, N), test_poly.device)
        acc[:, k] = body
        pt = (blog, levels, k, N)
        for i in range(n):
            kern = expand_bsk_kernel_s2d(bsk_bytes[i], k, levels, N,
                                         drop_limbs)
            acc = cmux_accumulate_s2d(acc, a_cols[i], kern, pt, drop_limbs,
                                      cross, engine)
        return acc
    strips_fn, front_fn, back_fn = fns
    if bigd_all is not None and bigd_all.shape[2] != (8 - drop_limbs) * (
            k + 1) * levels:
        raise ValueError(f"the strip table {tuple(bigd_all.shape)} was built "
                         f"at another drop_limbs than {drop_limbs}")
    # acc init, plane-major (k+1, M, N)
    acc = T.zeros((k + 1, M, N), test_poly.device)
    acc[k] = body
    for i in range(n):
        if bigd_all is None:
            strips = strips_fn(_bigd_rows(bsk_bytes[i], k, levels, N,
                                          drop_limbs), k_major=True)
        else:
            strips = bigd_all[i]
        dB0, dB1 = front_fn(acc, a_cols[i], blog, levels)
        acc = back_fn(dB0, dB1, strips, acc, drop_limbs, cross)
    return acc.transpose(0, 1).contiguous()


def sample_extract(acc: torch.Tensor, params: TFHEParams) -> torch.Tensor:
    """Constant coefficient as a big-LWE ciphertext: (M, k+1, N) ->
    (M, kN + 1); a_ext[j*N + i] = mask[j, 0] if i == 0 else
    -mask[j, N - i]; b_ext = body[0]."""
    k, N = params.glwe_dim, params.poly_size
    M = acc.shape[0]
    idx = (-torch.arange(N, device=acc.device)) % N
    g = acc[:, :k, idx]
    a_ext = torch.where(torch.arange(N, device=acc.device) != 0, -g, g)
    return torch.cat([a_ext.reshape(M, k * N), acc[:, k, 0:1]], dim=1)


def key_switch(big_ct: torch.Tensor, ksk_bytes: torch.Tensor,
               params: TFHEParams) -> torch.Tensor:
    """(M, kN+1) big-LWE -> (M, n+1) small-LWE (the PBS keyswitch)."""
    return lwe_key_switch(big_ct, ksk_bytes, params.ks_base_log,
                          params.ks_levels)


def lwe_key_switch(ct: torch.Tensor, ksk_bytes: torch.Tensor, blog: int,
                   levels: int, ks_drop: int = 0) -> torch.Tensor:
    """Generic LWE->LWE keyswitch (M, d_src+1) -> (M, d_dst+1):
    out = (0, .., 0, b) - sum_{i, level} d_{i,level} * KSK[i, level], as
    exact int8 byte-limb matmuls.  ksk_bytes: (d_src*levels, d_dst+1, 8).
    ks_drop skips the key's low ``ks_drop`` byte limbs."""
    kN = ksk_bytes.shape[0] // levels
    n = ksk_bytes.shape[1] - 1
    M = ct.shape[0]
    assert ct.shape[1] == kN + 1, (tuple(ct.shape), kN)
    digits = T.decompose(ct[:, :kN], blog, levels)       # (levels, M, kN)
    digits = digits.permute(1, 2, 0).reshape(M, kN * levels)
    dB = signed_byte_split(digits, _digit_bytes_count(blog))
    acc = T.zeros((M, n + 1), ct.device)
    for u in range(dB.shape[0]):
        for v in range(ks_drop, 8 - u):
            prod = int8_matmul(dB[u], ksk_bytes[:, :, v])
            acc = acc + (prod.to(I64) << (8 * (u + v)))
    out = -acc
    out[:, n] += ct[:, kN]
    return out


# ---------------------------------------------------------------------------
# full PBS


def make_test_polys(tables: torch.Tensor, params: TFHEParams,
                    out_delta_log2: int) -> torch.Tensor:
    """Per-sample integer tables (M, 2^r) -> lookup polynomials (M, N):
    window j holds tables[.., j] * 2^out_delta_log2, pre-rotated by half a
    window so the PBS rounds to the nearest index."""
    N = params.poly_size
    M, tsize = tables.shape
    assert tsize <= N, (
        f"TLU table of {tsize} entries exceeds the parameter set's "
        f"polynomial size N={N}")
    reps = N // tsize
    vals = T.from_i32_shifted(tables.repeat_interleave(reps, dim=1),
                              out_delta_log2)
    return static_negacyclic_roll(vals, 2 * N - reps // 2)


def bootstrap(ct: torch.Tensor, tables: torch.Tensor,
              dsk: DeviceServerKeys, params: TFHEParams, out_delta_log2: int,
              drop_limbs: int = 0, cross: int = 0,
              engine: str | None = None) -> torch.Tensor:
    """Batched programmable bootstrap, KS -> MS -> BR -> SE.

    ct: (M, kN+1) big-LWE encoding index u with Delta_in = 2^(64 - r - 1),
    tables.shape[1] == 2^r.  Returns (M, kN+1) big-LWE encrypting
    tables[u] * 2^out_delta_log2."""
    n, N = params.lwe_dim, params.poly_size
    small = key_switch(ct, dsk.ksk_bytes, params)
    ms = mod_switch(small, N)
    test = make_test_polys(tables.to(ct.device), params, out_delta_log2)
    acc = blind_rotate(test, ms[:, :n], ms[:, n], dsk.bsk_bytes, params,
                       drop_limbs, cross, engine=engine)
    return sample_extract(acc, params)


def bootstrap_chunked(ct: torch.Tensor, tables: torch.Tensor,
                      dsk: DeviceServerKeys, params: TFHEParams,
                      out_delta_log2: int, pbs_batch: int,
                      drop_limbs: int = 0, cross: int = 0,
                      engine: str | None = None) -> torch.Tensor:
    """:func:`bootstrap` over any number of sites in chunks of at most
    ``pbs_batch`` (sites are independent, so no padding is needed)."""
    outs = [bootstrap(ct[s:s + pbs_batch], tables[s:s + pbs_batch], dsk,
                      params, out_delta_log2, drop_limbs, cross, engine)
            for s in range(0, ct.shape[0], pbs_batch)]
    return torch.cat(outs, dim=0)


# ---------------------------------------------------------------------------
# exact rounding: LSB extraction on an auxiliary parameter set


def _body_add(ct: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Add a torus constant to the body (last) column."""
    out = ct.clone()
    out[:, -1] += c
    return out


def clear_low_bits(ct: torch.Tensor, aux_keys: DeviceAuxKeys,
                   aux_params: TFHEParams, n_in: int, shift: int,
                   back_base_log: int, back_levels: int,
                   drop_limbs: int = 0, cross: int = 0,
                   fwd_ks_drop: int = 0, back_ks_drop: int = 0,
                   keep_low: int = 0,
                   engine: str | None = None) -> torch.Tensor:
    """Subtract bits [keep_low, shift) of an n_in-bit-encoded accumulator.

    ct: (M, kN_main+1) big-LWE whose phase encodes v * 2^(63 - n_in),
    v >= 0.  One sign bootstrap on the aux lattice per cleared bit, LSB
    first (see the TPU package's ``pbs.clear_low_bits`` for the
    construction and the keep_low re-centering)."""
    n_aux, N_aux = aux_params.lwe_dim, aux_params.poly_size
    M = ct.shape[0]
    dev = ct.device
    w = ct
    for lo in range(keep_low, shift):
        t = T.shift_left(w, n_in - lo)
        off = T.from_i32_shifted(1, 62, dev)
        if keep_low > 0:
            off = off - T.from_i32_shifted((1 << keep_low) - 1, 62 - lo, dev)
        t = _body_add(t, off)
        small = lwe_key_switch(t, aux_keys.ksk_fwd_bytes,
                               aux_params.ks_base_log, aux_params.ks_levels,
                               fwd_ks_drop)
        ms = mod_switch(small, N_aux)
        # constant test poly -h, h = 2^(62 - n_in + lo): the rotate reads
        # -h for bit 0 and +h for bit 1; +h levelled gives bit * 2h
        h_log2 = 62 - n_in + lo
        h = T.from_i32_shifted(1, h_log2, dev)
        neg_h = (-h).expand(M, N_aux).contiguous()
        acc = blind_rotate(neg_h, ms[:, :n_aux], ms[:, n_aux],
                           aux_keys.bsk_bytes, aux_params, drop_limbs,
                           cross, engine=engine,
                           bigd_all=aux_keys.bigd_bytes)
        bit_big = _body_add(sample_extract(acc, aux_params), h)
        bit_main = lwe_key_switch(bit_big, aux_keys.ksk_back_bytes,
                                  back_base_log, back_levels, back_ks_drop)
        w = w - bit_main
    return w


def clear_low_bits_chunked(ct: torch.Tensor, aux_keys: DeviceAuxKeys,
                           aux_params: TFHEParams, n_in: int, shift: int,
                           back_base_log: int, back_levels: int,
                           aux_batch: int, drop_limbs: int = 0,
                           cross: int = 0, fwd_ks_drop: int = 0,
                           back_ks_drop: int = 0, keep_low: int = 0,
                           engine: str | None = None) -> torch.Tensor:
    """:func:`clear_low_bits` over any number of sites in chunks of at most
    ``aux_batch``."""
    outs = [clear_low_bits(ct[s:s + aux_batch], aux_keys, aux_params, n_in,
                           shift, back_base_log, back_levels, drop_limbs,
                           cross, fwd_ks_drop, back_ks_drop, keep_low,
                           engine)
            for s in range(0, ct.shape[0], aux_batch)]
    return torch.cat(outs, dim=0)
