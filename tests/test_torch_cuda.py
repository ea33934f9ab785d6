"""The CUDA kernels (K1 rotate_decompose in both layouts, K2
build_bigd_strips, K3 fused_external, K4 combine_accumulate, K5
rotate_diff) against their plain PyTorch versions on the card, at the
flagship's lattices and at the main lattices of presets 7 and 8 (N=4096,
N=8192; K3 also at its int32 bound), and the engines against each
other, bit for bit, preset-7 and -8 bootstraps included; the clear QAT
model's classes on the card against the CPU's; the trainer's step and
augmented ingest on the card against the CPU's; the batched transforms on the card against
the CPU's, and the native host codec against the card's ingest; the
sharded paths on one card: the encrypted forward over a 2-entry mesh and
the tile-sharded ingest.  Every test here but the last (the bench
tool's knobs against ``bench.py``'s) needs an NVIDIA GPU and skips on
the CPU.

This file imports no JAX and nothing of the JAX package, so it also runs
on a machine without them:
    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""
import os

# the trainer's deterministic run (test_training_on_the_card_is_reproducible)
# needs cuBLAS's fixed workspace, which PyTorch sizes at the process's first
# cuBLAS call: set here, at collection, before any test makes that call
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from dct_cryptonets_tpu_torch.fhe import keys as KEYS
from dct_cryptonets_tpu_torch.fhe import kernels as K
from dct_cryptonets_tpu_torch.fhe import pbs as P
from dct_cryptonets_tpu_torch.fhe import torus as T
from dct_cryptonets_tpu_torch.fhe.params import _PRESETS as PRESETS
from dct_cryptonets_tpu_torch.fhe.params import (TEST_PARAMS, TEST_PARAMS_K2,
                                                 ExactRoundingConfig)

pytestmark = pytest.mark.cuda

CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "checkpoints", "digits_flagship", "best.tar")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    K.build_kernels()
    return torch.device("cuda")


def inputs(seed, k, M, N, levels, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    J, rows = k + 1, (k + 1) * levels
    acc = torch.randint(-2 ** 63, 2 ** 63 - 1, (J, M, N), generator=g,
                        device=dev, dtype=torch.int64)
    amt = torch.randint(0, 2 * N, (M,), generator=g, device=dev,
                        dtype=torch.int32)
    amt[:3] = torch.tensor([0, N, 2 * N - 1], device=dev)[:M]
    bsk = torch.randint(-128, 128, (rows, J, 2 * N, 8), generator=g,
                        device=dev, dtype=torch.int8)
    return acc, amt, bsk


# K3 takes a 128 x 256 output tile where that fills the card's waves as
# well as 64 x 256 does (N=2048 at M=1000), else 64 x 256; M=129 and 4097
# cross an M tile edge, drop=7 keeps a single byte scale
@pytest.mark.parametrize("k,N,drop,cross,M", [
    (1, 256, 0, 0, 13), (2, 256, 2, 1, 256), (1, 2048, 0, 0, 300),
    (2, 512, 0, 1, 1000), (1, 4096, 3, 0, 64), (2, 512, 0, 0, 129),
    (2, 512, 2, 1, 4097), (1, 2048, 2, 1, 1000), (1, 256, 7, 0, 200)])
def test_cmux_kernels_match_plain(dev, k, N, drop, cross, M):
    acc, amt, bsk = inputs(k + N + M, k, M, N, 2, dev)
    got = K.rotate_decompose(acc, amt, 15, 2)
    want = K.rotate_decompose_plain(acc, amt, 15, 2)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    dbl = P._bigd_rows(bsk, k, 2, N, drop)
    assert torch.equal(K.build_bigd_strips(dbl),
                       K.build_bigd_strips_plain(dbl))
    strips = K.build_bigd_strips(dbl, k_major=True)
    assert torch.equal(strips, K.build_bigd_strips_plain(dbl, k_major=True))
    dB0, dB1 = want
    assert torch.equal(K.fused_external(dB0, dB1, strips, acc, drop, cross),
                       K.fused_external_plain(dB0, dB1, strips, acc, drop,
                                              cross))
    # the s2d engine's kernels on a sample-major (M, J, N) accumulator
    sm = acc.transpose(0, 1).contiguous()
    got = K.rotate_decompose(sm, amt, 15, 2, plane_major=False)
    want = K.rotate_decompose_plain(sm, amt, 15, 2, plane_major=False)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(K.rotate_diff(sm, amt), K.rotate_diff_plain(sm, amt))
    g = torch.Generator(device=dev).manual_seed(M)
    o0, o1 = (torch.randint(-2 ** 31, 2 ** 31 - 1, (M, (k + 1) * (8 - drop), N),
                            generator=g, device=dev, dtype=torch.int32)
              for _ in range(2))
    assert torch.equal(K.combine_accumulate(o0, o1, sm, drop, cross),
                       K.combine_accumulate_plain(o0, o1, sm, drop, cross))


# the noise audit's knobs: drop 1 to 4 leave 7 to 4 key limbs (K2 builds
# C = (8 - drop) * rows strip rows, not a multiple of 8 at odd drops), and
# cross 1 leaves the lowest byte scale without a pair; M crosses K3's tile
# edges on both flagship lattices
@pytest.mark.parametrize("M", [13, 129, 4097])
@pytest.mark.parametrize("cross", [0, 1])
@pytest.mark.parametrize("drop", [1, 3, 4])
@pytest.mark.parametrize("k,N", [(1, 2048), (2, 512)], ids=["main", "aux"])
def test_strips_and_external_product_at_knobs(dev, k, N, drop, cross, M):
    acc, amt, bsk = inputs(drop + 2 * cross + M, k, M, N, 2, dev)
    dbl = P._bigd_rows(bsk, k, 2, N, drop)
    for k_major in (False, True):
        assert torch.equal(K.build_bigd_strips(dbl, k_major),
                           K.build_bigd_strips_plain(dbl, k_major))
    strips = K.build_bigd_strips(dbl, k_major=True)
    dB0, dB1 = K.rotate_decompose(acc, amt, 15, 2)
    assert torch.equal(K.fused_external(dB0, dB1, strips, acc, drop, cross),
                       K.fused_external_plain(dB0, dB1, strips, acc, drop,
                                              cross))


def assert_k1_equal(acc, amt, blog, levels, plane_major):
    got = K.rotate_decompose(acc, amt, blog, levels, plane_major)
    want = K.rotate_decompose_plain(acc, amt, blog, levels, plane_major)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# every amount a = g*N + r in [0, 2N) once, r = 0 and a = N included
@pytest.mark.parametrize("plane_major", [True, False])
@pytest.mark.parametrize("N", [256, 512, 2048])
def test_rotate_decompose_every_amount(dev, N, plane_major):
    g = torch.Generator(device=dev).manual_seed(N)
    shape = (2, 2 * N, N) if plane_major else (2 * N, 2, N)
    acc = torch.randint(-2 ** 63, 2 ** 63 - 1, shape, generator=g,
                        device=dev, dtype=torch.int64)
    amt = torch.arange(2 * N, device=dev, dtype=torch.int32)
    assert_k1_equal(acc, amt, 15, 2, plane_major)


# K1 stages whole rows: the flagship lattices' N (512, 2048) and every other
# preset's, M across the grid's edges, both layouts
@pytest.mark.parametrize("plane_major", [True, False])
@pytest.mark.parametrize("M", [1, 13, 129, 4097])
@pytest.mark.parametrize("N", [256, 512, 2048, 4096, 8192])
def test_rotate_decompose_matches_plain(dev, N, M, plane_major):
    acc, amt, _ = inputs(N + M, 1, M, N, 2, dev)
    if not plane_major:
        acc = acc.transpose(0, 1).contiguous()
    assert_k1_equal(acc, amt, 15, 2, plane_major)


# other gadgets: N below one 16-byte store, and byte planes that take more
# than one pass over the row (N=8192 at 4 and 32 levels)
@pytest.mark.parametrize("N,J,blog,levels", [
    (1, 2, 15, 2), (2, 3, 15, 2), (8, 2, 8, 4), (16, 1, 1, 32),
    (256, 3, 10, 3), (4096, 2, 11, 2), (8192, 2, 8, 4), (8192, 1, 1, 32)])
def test_rotate_decompose_gadgets_match_plain(dev, N, J, blog, levels):
    g = torch.Generator(device=dev).manual_seed(N + levels)
    M = 37
    acc = torch.randint(-2 ** 63, 2 ** 63 - 1, (J, M, N), generator=g,
                        device=dev, dtype=torch.int64)
    amt = torch.randint(0, 2 * N, (M,), generator=g, device=dev,
                        dtype=torch.int32)
    assert_k1_equal(acc, amt, blog, levels, True)
    assert_k1_equal(acc.transpose(0, 1).contiguous(), amt, blog, levels,
                    False)


@pytest.mark.parametrize("k_major", [False, True])
@pytest.mark.parametrize("G", [1, 7])
@pytest.mark.parametrize("N", [128, 256, 512, 1024, 2048, 4096, 8192])
def test_bigd_strips_match_plain(dev, N, G, k_major):
    g = torch.Generator(device=dev).manual_seed(N + G)
    dbl = torch.randint(-128, 128, (1, G, 2 * N), generator=g, device=dev,
                        dtype=torch.int8)
    assert torch.equal(K.build_bigd_strips(dbl, k_major),
                       K.build_bigd_strips_plain(dbl, k_major))


# the larger main lattices, preset 7 (N=4096) and preset 8 (N=8192), k=1:
# every kernel against its plain version at M across K3's 64- and 128-row
# tile edges and the production batches, at the knobs the audit picks on
# the flagship and the single-scale drop 7
@pytest.mark.parametrize("drop,cross", [(0, 0), (2, 1), (3, 0), (4, 1),
                                        (7, 0)])
@pytest.mark.parametrize("M", [64, 129, 2048, 4097])
@pytest.mark.parametrize("N", [4096, 8192])
def test_large_lattice_kernels_match_plain(dev, N, M, drop, cross):
    acc, amt, bsk = inputs(N + M + drop, 1, M, N, 2, dev)
    got = K.rotate_decompose(acc, amt, 15, 2)
    want = K.rotate_decompose_plain(acc, amt, 15, 2)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    dbl = P._bigd_rows(bsk, 1, 2, N, drop)
    for k_major in (False, True):
        assert torch.equal(K.build_bigd_strips(dbl, k_major),
                           K.build_bigd_strips_plain(dbl, k_major))
    strips = K.build_bigd_strips(dbl, k_major=True)
    dB0, dB1 = want
    assert torch.equal(K.fused_external(dB0, dB1, strips, acc, drop, cross),
                       K.fused_external_plain(dB0, dB1, strips, acc, drop,
                                              cross))
    del got, want, dB0, dB1, strips
    sm = acc.transpose(0, 1).contiguous()
    del acc
    assert_k1_equal(sm, amt, 15, 2, False)
    assert torch.equal(K.rotate_diff(sm, amt), K.rotate_diff_plain(sm, amt))
    g = torch.Generator(device=dev).manual_seed(M + drop)
    o0, o1 = (torch.randint(-2 ** 31, 2 ** 31 - 1, (M, 2 * (8 - drop), N),
                            generator=g, device=dev, dtype=torch.int32)
              for _ in range(2))
    assert torch.equal(K.combine_accumulate(o0, o1, sm, drop, cross),
                       K.combine_accumulate_plain(o0, o1, sm, drop, cross))


# K3's int32 accumulator at its bound: every digit byte and key byte
# -128, so each of the 2 * rows * N terms of a byte scale is +2^14 and a
# scale's bucket reaches 2 * 4 * 8192 * 2^14 = 2^30 at N=8192 (with the
# carry of the scale below, under 2^31)
@pytest.mark.parametrize("N", [4096, 8192])
def test_fused_external_at_its_int32_bound(dev, N):
    M, rows = 129, 4
    acc = torch.zeros((2, M, N), dtype=torch.int64, device=dev)
    d = torch.full((rows, M, N), -128, dtype=torch.int8, device=dev)
    dbl = torch.full((2, 8 * rows, 2 * N), -128, dtype=torch.int8,
                     device=dev)
    strips = K.build_bigd_strips(dbl, k_major=True)
    got = K.fused_external(d, d, strips, acc, 0)
    assert torch.equal(got, K.fused_external_plain(d, d, strips, acc, 0))
    # scale 0 has one pair, scales 1 to 7 two; the pair of scale 8 wraps
    bucket = 2 * rows * N * 2 ** 14
    want = bucket // 2 + sum(bucket << (8 * s) for s in range(1, 8))
    assert torch.all(got == (want + 2 ** 63) % 2 ** 64 - 2 ** 63)


# one bootstrap chunk at each larger preset on random key bytes: the
# keyswitch at base 2^3 x 8 from kN = 4096 / 8192, test polynomials of
# 2^7 / 2^8 windows, n = 970 / 1024 CMUX steps
@pytest.mark.parametrize("preset", [7, 8])
def test_bootstrap_at_large_presets_kernel_equals_plain(dev, preset):
    from chip_smoke import random_server_keys

    par = PRESETS[preset]
    dsk = random_server_keys(par, dev, preset)
    g = torch.Generator(device=dev).manual_seed(preset + 1)
    M, kN = 64, par.glwe_dim * par.poly_size
    ct = torch.randint(-2 ** 63, 2 ** 63 - 1, (M, kN + 1), generator=g,
                       device=dev, dtype=torch.int64)
    tables = torch.randint(-2 ** 11, 2 ** 11, (M, 2 ** par.message_bits),
                           generator=g, device=dev, dtype=torch.int32)
    K.reset_launch_counts()
    got = P.bootstrap(ct, tables, dsk, par, par.delta_log2)
    n = par.lwe_dim
    assert K.launch_counts() == {"rotate_decompose": n,
                                 "build_bigd_strips": n, "fused_external": n,
                                 "combine_accumulate": 0, "rotate_diff": 0}
    want = P.bootstrap(ct, tables, dsk, par, par.delta_log2, engine="plain")
    assert got.shape == (M, kN + 1)
    assert torch.equal(got, want)


@pytest.mark.parametrize("par", [TEST_PARAMS, TEST_PARAMS_K2],
                         ids=["k1", "k2"])
def test_bootstrap_kernel_engine_equals_plain(dev, par):
    ck = KEYS.keygen(par, seed=3)
    dsk = P.preprocess_server_keys(KEYS.make_server_keys(ck, seed=4), dev)
    rng = np.random.default_rng(5)
    msgs = rng.integers(0, 8, 40)
    ct = T.from_u64(KEYS.encrypt_lwe(
        ck, msgs.astype(np.uint64) << np.uint64(60), rng,
        key=ck.big_lwe_key, noise_log2=par.glwe_noise_log2), dev)
    tables = torch.as_tensor(rng.integers(-4, 4, (40, 8)), dtype=torch.int32,
                             device=dev)
    K.reset_launch_counts()
    got = P.bootstrap(ct, tables, dsk, par, 60)
    n = par.lwe_dim
    assert K.launch_counts() == {"rotate_decompose": n,
                                 "build_bigd_strips": n, "fused_external": n,
                                 "combine_accumulate": 0, "rotate_diff": 0}
    want = P.bootstrap(ct, tables, dsk, par, 60, engine="plain")
    assert torch.equal(got, want)
    phase = KEYS.decrypt_lwe(ck, T.to_u64(got), key=ck.big_lwe_key)
    dec = np.round(phase.astype(np.int64) / 2.0 ** 60).astype(np.int64)
    np.testing.assert_array_equal(dec, tables.cpu().numpy()[np.arange(40),
                                                            msgs])


@pytest.mark.parametrize("par", [TEST_PARAMS, TEST_PARAMS_K2],
                         ids=["k1", "k2"])
@pytest.mark.parametrize("drop,cross", [(2, 1), (4, 1)])
def test_bootstrap_kernel_engine_equals_plain_at_knobs(dev, par, drop, cross):
    ck = KEYS.keygen(par, seed=3)
    dsk = P.preprocess_server_keys(KEYS.make_server_keys(ck, seed=4), dev)
    rng = np.random.default_rng(7 + drop)
    msgs = rng.integers(0, 8, 40)
    ct = T.from_u64(KEYS.encrypt_lwe(
        ck, msgs.astype(np.uint64) << np.uint64(60), rng,
        key=ck.big_lwe_key, noise_log2=par.glwe_noise_log2), dev)
    tables = torch.as_tensor(rng.integers(-4, 4, (40, 8)), dtype=torch.int32,
                             device=dev)
    got = P.bootstrap_chunked(ct, tables, dsk, par, 60, 16, drop, cross)
    assert torch.equal(got, P.bootstrap_chunked(ct, tables, dsk, par, 60, 16,
                                                drop, cross, engine="plain"))


# the extraction path of the audit policy: truncated keyswitches on both
# hops, the lowest bits kept (keep_low) and the aux knob
@pytest.mark.parametrize("drop,cross,fwd,back,keep", [
    (2, 1, 5, 3, 1), (0, 0, 1, 1, 2), (4, 1, 6, 3, 0)])
def test_clear_low_bits_kernel_engine_equals_plain_at_knobs(dev, drop, cross,
                                                            fwd, back, keep):
    ck = KEYS.keygen(TEST_PARAMS, seed=3)
    cfg = ExactRoundingConfig(TEST_PARAMS_K2)
    ak = P.preprocess_aux_keys(KEYS.make_aux_server_keys(
        ck, cfg.aux, seed=4, back_base_log=cfg.back_base_log,
        back_levels=cfg.back_levels), dev)
    rng = np.random.default_rng(9 + keep)
    n_in, shift = 11, 3
    v = rng.integers(0, 1 << n_in, 37)
    ct = T.from_u64(KEYS.encrypt_lwe(
        ck, v.astype(np.uint64) << np.uint64(63 - n_in), rng,
        key=ck.big_lwe_key, noise_log2=TEST_PARAMS.glwe_noise_log2), dev)
    args = (ct, ak, cfg.aux, n_in, shift, cfg.back_base_log, cfg.back_levels,
            16, drop, cross, fwd, back, keep)
    K.reset_launch_counts()
    got = P.clear_low_bits_chunked(*args)
    assert K.launch_counts()["fused_external"] == (
        3 * (shift - keep) * cfg.aux.lwe_dim)
    assert torch.equal(got, P.clear_low_bits_chunked(*args, engine="plain"))


@pytest.mark.parametrize("par", [TEST_PARAMS, TEST_PARAMS_K2],
                         ids=["k1", "k2"])
@pytest.mark.parametrize("drop,cross", [(0, 0), (2, 1)])
def test_bootstrap_s2d_engine_equals_kernel(dev, par, drop, cross):
    ck = KEYS.keygen(par, seed=3)
    dsk = P.preprocess_server_keys(KEYS.make_server_keys(ck, seed=4), dev)
    rng = np.random.default_rng(6 + drop)
    msgs = rng.integers(0, 8, 40)
    ct = T.from_u64(KEYS.encrypt_lwe(
        ck, msgs.astype(np.uint64) << np.uint64(60), rng,
        key=ck.big_lwe_key, noise_log2=par.glwe_noise_log2), dev)
    tables = torch.as_tensor(rng.integers(-4, 4, (40, 8)), dtype=torch.int32,
                             device=dev)
    K.reset_launch_counts()
    got = P.bootstrap(ct, tables, dsk, par, 60, drop, cross, engine="s2d")
    n = par.lwe_dim
    assert K.launch_counts() == {"rotate_decompose": n,
                                 "build_bigd_strips": 0, "fused_external": 0,
                                 "combine_accumulate": n, "rotate_diff": 0}
    for engine in ("kernel", "s2d_plain"):
        assert torch.equal(got, P.bootstrap(ct, tables, dsk, par, 60, drop,
                                            cross, engine=engine))


@pytest.mark.parametrize("par", [TEST_PARAMS, TEST_PARAMS_K2],
                         ids=["k1", "k2"])
@pytest.mark.parametrize("drop", [0, 3])
def test_strip_table_is_every_steps_strips(dev, par, drop):
    """The precomputed strip table: one K2 launch, and entry i equal to
    what the fused engine's CMUX step i builds, and to the plain table."""
    k, N, levels = par.glwe_dim, par.poly_size, par.pbs_levels
    g = torch.Generator(device=dev).manual_seed(11 + drop)
    bsk = torch.randint(-128, 128, (par.lwe_dim, (k + 1) * levels, k + 1,
                                    2 * N, 8), generator=g, device=dev,
                        dtype=torch.int8)
    K.reset_launch_counts()
    table = P.precompute_bigd_strips(bsk, k, levels, N, drop)
    assert K.launch_counts()["build_bigd_strips"] == 1
    for i in range(par.lwe_dim):
        assert torch.equal(table[i], K.build_bigd_strips(
            P._bigd_rows(bsk[i], k, levels, N, drop), k_major=True))
    assert torch.equal(table.cpu(), P.precompute_bigd_strips(
        bsk.cpu(), k, levels, N, drop))


@pytest.mark.parametrize("drop,cross,fwd,back,keep", [
    (2, 1, 5, 3, 1), (0, 0, 0, 0, 0)])
def test_clear_low_bits_fed_from_the_strip_table(dev, drop, cross, fwd, back,
                                                 keep):
    """``with_precomputed_strips`` attaches the table on the card (under
    the default 2 GiB gate at these sizes); the table-fed extraction
    launches no K2 and equals the per-step one and the plain engine."""
    ck = KEYS.keygen(TEST_PARAMS, seed=3)
    cfg = ExactRoundingConfig(TEST_PARAMS_K2)
    ak = P.preprocess_aux_keys(KEYS.make_aux_server_keys(
        ck, cfg.aux, seed=4, back_base_log=cfg.back_base_log,
        back_levels=cfg.back_levels), dev)
    with_table = P.with_precomputed_strips(ak, cfg.aux, drop)
    assert with_table.bigd_bytes is not None
    assert with_table.bigd_bytes.numel() == P.strip_table_bytes(ak, drop)
    rng = np.random.default_rng(13 + drop)
    n_in, shift = 11, 3
    v = rng.integers(0, 1 << n_in, 37)
    ct = T.from_u64(KEYS.encrypt_lwe(
        ck, v.astype(np.uint64) << np.uint64(63 - n_in), rng,
        key=ck.big_lwe_key, noise_log2=TEST_PARAMS.glwe_noise_log2), dev)
    rest = (cfg.aux, n_in, shift, cfg.back_base_log, cfg.back_levels, 16,
            drop, cross, fwd, back, keep)
    K.reset_launch_counts()
    got = P.clear_low_bits_chunked(ct, with_table, *rest)
    steps = 3 * (shift - keep) * cfg.aux.lwe_dim
    assert K.launch_counts() == {"rotate_decompose": steps,
                                 "build_bigd_strips": 0,
                                 "fused_external": steps,
                                 "combine_accumulate": 0, "rotate_diff": 0}
    assert torch.equal(got, P.clear_low_bits_chunked(ct, ak, *rest))
    assert torch.equal(got, P.clear_low_bits_chunked(ct, with_table, *rest,
                                                     engine="plain"))
    with pytest.raises(ValueError, match="drop_limbs"):
        P.clear_low_bits(ct, with_table, cfg.aux, n_in, shift,
                         cfg.back_base_log, cfg.back_levels, drop + 1)


def test_tpu_engine_names_on_the_card(dev):
    """``engine="fused"`` launches the kernels as ``"kernel"`` does, and
    ``"conv"`` runs the plain version on the card's tensors."""
    par = TEST_PARAMS
    ck = KEYS.keygen(par, seed=3)
    dsk = P.preprocess_server_keys(KEYS.make_server_keys(ck, seed=4), dev)
    rng = np.random.default_rng(17)
    msgs = rng.integers(0, 8, 24)
    ct = T.from_u64(KEYS.encrypt_lwe(
        ck, msgs.astype(np.uint64) << np.uint64(60), rng,
        key=ck.big_lwe_key, noise_log2=par.glwe_noise_log2), dev)
    tables = torch.as_tensor(rng.integers(-4, 4, (24, 8)), dtype=torch.int32,
                             device=dev)
    K.reset_launch_counts()
    fused = P.bootstrap(ct, tables, dsk, par, 60, engine="fused")
    assert K.launch_counts()["fused_external"] == par.lwe_dim
    K.reset_launch_counts()
    conv = P.bootstrap(ct, tables, dsk, par, 60, engine="conv")
    assert not any(K.launch_counts().values())
    assert torch.equal(fused, conv)
    assert torch.equal(fused, P.bootstrap(ct, tables, dsk, par, 60))


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    acc, amt, bsk = inputs(1, 1, 16, 256, 2, dev)
    with pytest.raises(ValueError, match="contiguous"):
        K.rotate_decompose(acc.transpose(1, 2), amt, 15, 2)
    with pytest.raises(ValueError, match="torch.int64"):
        K.rotate_decompose(acc.to(torch.int32), amt, 15, 2)
    dB0, dB1 = K.rotate_decompose(acc, amt, 15, 2)
    strips = K.build_bigd_strips(P._bigd_rows(bsk, 1, 2, 256, 0),
                                 k_major=True)
    with pytest.raises(ValueError, match="bigd"):
        K.fused_external(dB0, dB1, strips, acc, 2, 0)   # strips of drop 0
    with pytest.raises(ValueError, match="CUDA"):
        K.fused_external(dB0, dB1, strips.cpu(), acc, 0, 0)
    for N, blog, levels in ((768, 15, 2), (2 * K.K1_MAX_N, 15, 2),
                            (256, 16, 2), (256, 11, 3)):
        a = torch.zeros((2, 3, N), dtype=torch.int64, device=dev)
        with pytest.raises(ValueError, match="unsupported"):
            K.rotate_decompose(a, amt[:3], blog, levels)
    for N in (64, 192, 2 * K.K2_MAX_N):
        with pytest.raises(ValueError, match="unsupported"):
            K.build_bigd_strips(torch.zeros((1, 1, 2 * N), dtype=torch.int8,
                                            device=dev))
    padded = torch.zeros((1, 1, 2 * 256 + 16), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="aligned"):
        K.build_bigd_strips(padded[..., 1:2 * 256 + 1])
    o = torch.zeros((16, 2 * 8, 256), dtype=torch.int32, device=dev)
    K.combine_accumulate(o, o, acc.transpose(0, 1).contiguous(), 0)
    with pytest.raises(ValueError, match="o0"):
        K.combine_accumulate(o, o, acc, 0)          # plane-major acc


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def test_clear_model_classes_on_the_card_equal_the_cpus(card):
    """The flagship's clear QAT model gives the CPU's classes on the card
    with cuDNN's TF32 flag at its default (on): the model runs its
    convolutions in full float32 whoever calls it."""
    from dct_cryptonets_tpu_torch.checkpoint import load_ckpt
    from dct_cryptonets_tpu_torch.data import pipeline
    from dct_cryptonets_tpu_torch.data.codec import CodecConfig
    from dct_cryptonets_tpu_torch.homomorphic_eval import make_ingest
    from dct_cryptonets_tpu_torch.models.resnet import QATResNet, build_spec

    params, state = load_ckpt(CKPT)["state"]
    spec = build_spec("ResNet20qat", in_channels=24, img_size=16)
    cfg = CodecConfig(24, 4, 16)
    testset = pipeline.get_dataset("synthetic", None, False,
                                   image_size=cfg.pixel_size)
    x = make_ingest(cfg, "cpu")(testset.gather(np.arange(8))[0])
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with torch.no_grad():
            want = QATResNet(params, state, spec).eval()(x)[1].argmax(1)
            got = QATResNet(params, state, spec).to(card).eval()(
                x.to(card))[1].argmax(1)
        assert torch.equal(got.cpu(), want)
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = before


def one_train_step(params, state, spec, x, labels, device):
    """One Adam step of the trainer in float64 from a pytree on ``device``:
    (loss, params, state, gradients) after it."""
    from dct_cryptonets_tpu_torch import train as TRAIN
    from dct_cryptonets_tpu_torch.models.resnet import QATResNet

    dt = torch.float64
    model = QATResNet.from_params(params, state, spec).to(device, dt)
    cfg = TRAIN.parse_args("train", ["--device", device.type])
    opt = TRAIN.make_optimizer(cfg, cfg.lr, model.parameters())
    loss, _ = TRAIN.train_step(model, opt, cfg, x.to(device, dt),
                               labels.to(device), torch.Generator())
    grads = [p.grad.cpu().numpy() for p in model.parameters()]
    return float(loss), *model.to_params(), grads


def test_train_step_on_the_card_matches_the_cpu(card):
    """One Adam step of a ResNet20qat (24 ch, 8x8) from the same
    calibrated init on the same batch, in float64: the loss, the gradients
    and the BatchNorm state agree to 1e-9; so do the weights but where
    Adam's first step (about the LR whatever the gradient's size) turns a
    gradient within rounding of 0 either way (at most 1e-4 of them).  (In
    float32 a rounding flips about 1e-5 of the 4-bit fake-quant
    roundings, each moving the step; float64 makes a flip vanishingly
    rare, so the comparison sees the arithmetic.)"""
    from dct_cryptonets_tpu_torch.data import pipeline
    from dct_cryptonets_tpu_torch.data.codec import CodecConfig, dct_ingest
    from dct_cryptonets_tpu_torch.models.resnet import (
        build_spec, calibrate_scales, init_model, tree_leaves)

    spec = build_spec("ResNet20qat", in_channels=24, img_size=8)
    cfg = CodecConfig(24, 4, 8)
    ds = pipeline.get_dataset("synthetic", None, True, image_size=32)
    x = dct_ingest(ds.images[:64], cfg)
    labels = torch.as_tensor(ds.labels[32:64].astype(np.int64))
    params, state = init_model(spec)
    params = calibrate_scales(params, state, x[:32], spec)
    cpu = one_train_step(params, state, spec, x[32:], labels,
                         torch.device("cpu"))
    gpu = one_train_step(params, state, spec, x[32:], labels, card)
    np.testing.assert_allclose(gpu[0], cpu[0], rtol=1e-9)
    for g, c in zip(tree_leaves((gpu[2], gpu[3])),
                    tree_leaves((cpu[2], cpu[3]))):
        np.testing.assert_allclose(g, c, rtol=0,
                                   atol=1e-9 * np.abs(c).max() + 1e-30)
    dw = np.concatenate([np.abs(g - c).ravel() for g, c in zip(
        tree_leaves(gpu[1]), tree_leaves(cpu[1]))])
    assert (dw > 1e-9).mean() <= 1e-4 and dw.max() <= 2.1e-3


def test_training_on_the_card_is_reproducible(card, tmp_path):
    """Two runs of the trainer on the card from one seed (a few steps of
    the digits recipe, augmentation on) end with the same weights, BN
    state and optimizer state, bit for bit: the CUDA run takes
    deterministic algorithms only.  It rests on CUBLAS_WORKSPACE_CONFIG
    being set before the test run's first cuBLAS call (the module's top)."""
    from dct_cryptonets_tpu_torch import train as TRAIN
    from dct_cryptonets_tpu_torch.checkpoint import load_ckpt
    from dct_cryptonets_tpu_torch.models.resnet import tree_leaves

    runs = []
    for i in range(2):
        d = str(tmp_path / f"run{i}")
        TRAIN.main(["--dataset", "digits", "--dct_status", "--train_aug",
                    "--model", "ResNet20qat", "--channels", "24",
                    "--filter_size", "4", "--image_size_dct", "16",
                    "--batch_size", "128", "--lr", "0.001", "--optimizer",
                    "adam", "--stop_epoch", "1", "--checkpoint_dir", d])
        runs.append(load_ckpt(os.path.join(d, "0.tar")))
    assert not torch.are_deterministic_algorithms_enabled()
    a, b = ((r["state"], r["optimizer"]) for r in runs)
    leaves = list(zip(tree_leaves(a), tree_leaves(b)))
    assert len(leaves) > 100
    for x, y in leaves:
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_backward_convolutions_run_without_tf32(card):
    """With cuDNN's TF32 flag on, the trainer's backward convolutions run
    with it off (a hook in every convolution's backward reads it), and
    the caller's flag is back after the step."""
    from dct_cryptonets_tpu_torch import train as TRAIN
    from dct_cryptonets_tpu_torch.models import resnet as RES

    spec = RES.build_spec("ResNet20qat", in_channels=24, img_size=8)
    model = RES.QATResNet.from_params(*RES.init_model(spec), spec).to(card)
    seen = []
    for m in model.modules():
        if isinstance(m, RES._QConv):
            m.register_full_backward_hook(
                lambda *_: seen.append(torch.backends.cudnn.allow_tf32))
    cfg = TRAIN.parse_args("train", [])
    opt = TRAIN.make_optimizer(cfg, cfg.lr, model.parameters())
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        x = torch.randn((16, 8, 8, 24), device=card)
        TRAIN.train_step(model, opt, cfg, x, torch.arange(16, device=card)
                         % 10, torch.Generator())
        assert len(seen) == 21 and not any(seen)
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = before


def test_dct_ingest_train_on_the_card_matches_the_cpu(card):
    """The same generator seed gives the same draws on both devices; the
    rounded pixels agree but for a rare float32 tie (at most 1e-3 of them,
    by one level), and the DCT of the same pixels to float32 rounding (4
    ulps of the largest coefficient)."""
    from dct_cryptonets_tpu_torch.data import codec as PC

    cfg = PC.CodecConfig(24, 4, 16)
    x = torch.as_tensor(np.random.default_rng(0).integers(
        0, 256, (32, 64, 64, 3)).astype(np.uint8))
    draws = PC.draw_train(torch.Generator().manual_seed(5), 32, 64, 64)
    cpu = PC.augment(x, draws, cfg.pixel_size)
    gpu = PC.augment(x.to(card), draws, cfg.pixel_size).cpu()
    d = (gpu - cpu).abs()
    assert (d > 0).float().mean() <= 1e-3 and d.max() <= 1
    got = PC.dct_from_pixels(cpu.to(card), cfg).cpu()
    want = PC.dct_from_pixels(cpu, cfg)
    ulp = np.spacing(np.float32(want.abs().max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=4 * ulp)
    a = PC.dct_ingest_train(torch.Generator().manual_seed(5), x.to(card),
                            cfg)
    assert a.is_cuda and a.shape == (32, 16, 16, 24)


@pytest.mark.parametrize("B,P", [(128, 32), (16, 448)])
def test_transforms_on_the_card_match_the_cpu(card, B, P):
    """Every deterministic transform of ``data/transforms.py`` on the card
    against the CPU, on the same draws from a CPU generator, within the
    tolerances ``chip_smoke.transform_cases`` states (bit for bit where
    no float32 sum or library function differs)."""
    import chip_smoke

    g = torch.Generator().manual_seed(P)
    x = torch.rand((B, P, P, 3), generator=g) * 255
    for name, (fn, tol) in chip_smoke.transform_cases(x, g).items():
        err = float((fn(x.to(card)).cpu() - fn(x)).abs().max())
        assert err <= tol, (name, err, tol)


@pytest.mark.parametrize("fs,S,ch", [(4, 16, 24), (8, 56, 64)])
def test_native_codec_matches_the_cards_ingest(card, fs, S, ch):
    """The native host codec (built into build/native/) against the card's
    ``dct_from_pixels`` at the CIFAR and the ResNet18 presets, at
    tests/test_native_codec.py's tolerance (99 % of elements within 5e-2,
    none off by 2 or more)."""
    from dct_cryptonets_tpu_torch.data import native as NATIVE
    from dct_cryptonets_tpu_torch.data.codec import (CodecConfig,
                                                     dct_from_pixels)

    cfg = CodecConfig(ch, fs, S)
    imgs = np.random.default_rng(fs).integers(
        0, 256, (8, cfg.pixel_size, cfg.pixel_size, 3)).astype(np.uint8)
    host = NATIVE.dct_ingest_native(imgs, cfg)
    dev = dct_from_pixels(torch.as_tensor(imgs, device=card), cfg)
    diff = np.abs(host - dev.cpu().numpy())
    assert (diff < 5e-2).mean() > 0.99 and diff.max() < 2.0


def test_mesh_forward_on_one_card_equals_unsharded(card):
    """``forward(fhe="execute", mesh=data_mesh(2))`` on one card (both
    entries ``cuda:0``, the keys shared) on ``TEST_PARAMS``: a batch of 3
    padded to 4 gives the unsharded run's features of the padded batch
    (same keys, same Csprng), bit for bit, and launches K1-K3."""
    from dct_cryptonets_tpu_torch.fhe.keys import Csprng
    from dct_cryptonets_tpu_torch.fhe.runtime import compile_qat_model
    from dct_cryptonets_tpu_torch.homomorphic_eval import (
        calibrate_random_init)
    from dct_cryptonets_tpu_torch.models import resnet as RES
    from dct_cryptonets_tpu_torch.models.topology import StemSpec
    from dct_cryptonets_tpu_torch.parallel import data_mesh

    K.build_kernels()
    spec = RES.ModelSpec("tinyqat", (1,), (4,), 3, 4, num_classes=4,
                         bit_width=3, stem_override=StemSpec(
                             1, 1, 0, None, None, 4, True))
    x = torch.randn((8, 4, 4, 3), generator=torch.Generator().manual_seed(1))
    params, state = calibrate_random_init(
        *RES.init_model(spec, torch.Generator().manual_seed(0)), x, spec)
    m = compile_qat_model(params, state, spec, n_bits=3,
                          rounding_threshold_bits=3, calib_absmax=2.0,
                          tfhe_params=TEST_PARAMS, pbs_batch=512, device=card)
    m.keygen(seed=6)
    xq = np.clip(np.random.default_rng(5).normal(0, 0.7, (3, 4, 4, 3)),
                 -2, 2).astype(np.float32)
    x_pad = np.concatenate([xq, xq[-1:]], axis=0)
    want = m.forward(x_pad, fhe="execute", enc_rng=Csprng(9))[:3]
    mesh = data_mesh(2)
    assert mesh.devices == (torch.device("cuda", 0),) * 2
    m.shard_over(mesh)
    K.reset_launch_counts()
    got = m.forward(xq, fhe="execute", mesh=mesh, enc_rng=Csprng(9))
    counts = K.launch_counts()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, m.forward(xq, fhe="simulate"))
    assert all(counts[k] > 0 for k in (
        "rotate_decompose", "build_bigd_strips", "fused_external")), counts


@pytest.mark.parametrize("fs,S,ch,size", [(4, 16, 24, 80), (8, 56, 64, 448)])
def test_dct_ingest_sharded_on_the_card(card, fs, S, ch, size):
    """The tile-sharded ingest on a 4-entry one-card mesh equals the
    card's ``dct_ingest`` bit for bit, and the CPU's sharded ingest to
    float32 rounding (4 ulps of the largest value, as the card's DCT
    against the CPU's)."""
    from dct_cryptonets_tpu_torch.data import (CodecConfig, dct_ingest,
                                               dct_ingest_sharded)
    from dct_cryptonets_tpu_torch.parallel import data_mesh

    cfg = CodecConfig(ch, fs, S)
    imgs = torch.as_tensor(np.random.default_rng(fs).integers(
        0, 256, (2, size, size, 3)).astype(np.uint8))
    got = dct_ingest_sharded(imgs.to(card), cfg, data_mesh(4))
    assert got.is_cuda
    assert torch.equal(got, dct_ingest(imgs.to(card), cfg))
    want = dct_ingest_sharded(imgs, cfg, data_mesh(4, devices="cpu"))
    ulp = np.spacing(np.float32(want.abs().max()))
    np.testing.assert_allclose(got.cpu(), want, rtol=0, atol=4 * ulp)


def test_bench_model_knobs_match_bench_py():
    """``tools/bench_model.py`` reads ``bench.py``'s four environment knobs
    with its defaults on an accelerator (bench.py imports no JAX at its
    top, so it loads here)."""
    import bench
    from dct_cryptonets_tpu_torch.tools import bench_model as BM

    assert BM.knobs({}) == {"M": 2048, "mode": "exact",
                            "model": "ResNet20qat", "preset": None}
    assert BM.knobs({"BENCH_M": "64", "BENCH_MODE": "approximate",
                     "BENCH_MODEL": "ResNet18qat", "BENCH_PRESET": "7"}) == {
        "M": 64, "mode": "approximate", "model": "ResNet18qat", "preset": 7}
    assert BM.REF_LATENCY == bench.REF_LATENCY
    for bad in ({"BENCH_MODEL": "ResNet20"}, {"BENCH_MODE": "exactly"}):
        with pytest.raises(ValueError):
            BM.knobs(bad)
