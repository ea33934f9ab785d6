"""The port's s2d CMUX engine against the JAX package's ``engine="s2d"``,
bit for bit: the sample-major K1 (rotate_decompose), K4
(combine_accumulate) and K5 (rotate_diff) plain versions against the
Pallas kernels in interpret mode, the int8 GEMM external product against
the JAX space-to-depth conv, one CMUX step, bootstrap and clear_low_bits.
The CUDA kernels are held against these plain versions on the card by
``test_torch_cuda.py``."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dct_cryptonets_tpu.fhe import keys as KEYS
from dct_cryptonets_tpu.fhe import pallas_kernels as JK
from dct_cryptonets_tpu.fhe import pbs as JP
from dct_cryptonets_tpu.fhe import torus as JT
from dct_cryptonets_tpu.fhe.params import (TEST_PARAMS, TEST_PARAMS_K2,
                                           ExactRoundingConfig)
from dct_cryptonets_tpu_torch.fhe import kernels as K
from dct_cryptonets_tpu_torch.fhe import pbs as P
from dct_cryptonets_tpu_torch.fhe import torus as T

torch.set_num_threads(1)

N, LEVELS, BLOG = 256, 2, 15
U64 = np.uint64
DROP_CROSS = [(0, 0), (2, 0), (0, 1), (2, 1)]


def rand_u64(rng, shape):
    x = rng.integers(0, 1 << 63, shape, dtype=np.int64).astype(U64)
    return (x << U64(1)) | rng.integers(0, 2, shape).astype(U64)


def sample_major_inputs(seed, k, M):
    """acc (M, k+1, N) uint64, amounts (M,) with the edge amounts 0, N and
    2N-1 first, and one step's GGSW byte limbs (rows, k+1, 2N, 8)."""
    rng = np.random.default_rng(seed)
    acc = rand_u64(rng, (M, k + 1, N))
    amounts = rng.integers(0, 2 * N, M).astype(np.int32)
    amounts[:3] = [0, N, 2 * N - 1]
    bsk_i = rng.integers(-128, 128, ((k + 1) * LEVELS, k + 1, 2 * N, 8),
                         dtype=np.int8)
    return acc, amounts, bsk_i


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("M", [8, 13])
def test_rotate_decompose_sample_major_matches_pallas(k, M):
    acc, amounts, _ = sample_major_inputs(60 + k + M, k, M)
    jacc = JT.from_u64(acc)
    want = JK.rotate_decompose(jacc.hi, jacc.lo, jnp.asarray(amounts), BLOG,
                               LEVELS, 2, block_m=M, interpret=True,
                               plane_major=False)
    got = K.rotate_decompose(T.from_u64(acc), torch.from_numpy(amounts),
                             BLOG, LEVELS, plane_major=False)
    for g, w in zip(got, want):
        assert g.shape == ((M, (k + 1) * LEVELS, N))
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("drop,cross", DROP_CROSS)
def test_combine_accumulate_plain_matches_pallas(k, drop, cross):
    """Full-range int32 terms, so the int32 bucket sums wrap as on the TPU."""
    M, J = 13, k + 1
    rng = np.random.default_rng(70 + k + 3 * drop + cross)
    acc = rand_u64(rng, (M, J, N))
    o = rng.integers(-2 ** 31, 2 ** 31, (2, M, J * (8 - drop), N),
                     dtype=np.int64).astype(np.int32)
    jacc = JT.from_u64(acc)
    hi, lo = JK.combine_accumulate(jnp.asarray(o[0]), jnp.asarray(o[1]),
                                   jacc.hi, jacc.lo, drop, cross, block_m=M,
                                   interpret=True)
    got = K.combine_accumulate(torch.from_numpy(o[0]), torch.from_numpy(o[1]),
                               T.from_u64(acc), drop, cross)
    np.testing.assert_array_equal(T.to_u64(got), JT.to_u64(JT.T64(hi, lo)))


@pytest.mark.parametrize("k,drop", [(1, 0), (2, 2), (1, 3)])
def test_s2d_product_matches_jax_conv(k, drop):
    """The GEMM against the stacked Toeplitz operand == the JAX stride-16
    space-to-depth conv, on both digit-byte ranges."""
    _, _, bsk_i = sample_major_inputs(80 + k + drop, k, 8)
    rng = np.random.default_rng(90 + k)
    dB = rng.integers(-128, 128, (13, (k + 1) * LEVELS, N), dtype=np.int8)
    jkern = JP.expand_bsk_kernel_s2d(jnp.asarray(bsk_i), k, LEVELS, N, drop)
    kern = P.expand_bsk_kernel_s2d(torch.from_numpy(bsk_i), k, LEVELS, N,
                                   drop)
    assert kern.shape == ((k + 1) * LEVELS * N, (k + 1) * (8 - drop) * N)
    for d in (dB, dB // 2):
        want = JP.conv_external_s2d(jnp.asarray(d), jkern, k, N, drop)
        got = P.conv_external_s2d(torch.from_numpy(d), kern, k, N, drop)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k,drop,cross", [(1, 0, 0), (2, 2, 1)])
def test_cmux_step_s2d_matches_jax(k, drop, cross):
    """K1 sample-major -> GEMMs -> K4 == JAX ``cmux_accumulate_pallas``."""
    M = 13
    acc, amounts, bsk_i = sample_major_inputs(100 + k, k, M)
    pt = (BLOG, LEVELS, k, N)
    jkern = JP.expand_bsk_kernel_s2d(jnp.asarray(bsk_i), k, LEVELS, N, drop)
    want = JP.cmux_accumulate_pallas(JT.from_u64(acc), jnp.asarray(amounts),
                                     jkern, pt, drop, cross)
    kern = P.expand_bsk_kernel_s2d(torch.from_numpy(bsk_i), k, LEVELS, N,
                                   drop)
    got = P.cmux_accumulate_s2d(T.from_u64(acc), torch.from_numpy(amounts),
                                kern, pt, drop, cross)
    np.testing.assert_array_equal(T.to_u64(got), JT.to_u64(want))


@pytest.fixture(scope="module", params=["k1", "k2"])
def material(request):
    par = TEST_PARAMS if request.param == "k1" else TEST_PARAMS_K2
    ck = KEYS.keygen(par, seed=7)
    sk = KEYS.make_server_keys(ck, seed=8)
    return par, ck, JP.preprocess_server_keys(sk), P.preprocess_server_keys(sk)


@pytest.mark.parametrize("drop,cross", DROP_CROSS)
def test_bootstrap_s2d_matches_jax_s2d(material, drop, cross):
    """The port's s2d_plain (whole and chunked) == JAX engine="s2d" == the
    port's fused plain engine, at each (drop_limbs, cross)."""
    par, ck, jd, td = material
    rng = np.random.default_rng(41 + drop + 10 * cross)
    M, bits = 8, 3
    msgs = rng.integers(0, 2 ** bits, M)
    ct = KEYS.encrypt_lwe(ck, msgs.astype(U64) << U64(64 - bits - 1), rng,
                          key=ck.big_lwe_key, noise_log2=par.glwe_noise_log2)
    tables = rng.integers(-4, 4, (M, 2 ** bits)).astype(np.int32)
    want = JT.to_u64(JP.bootstrap(JT.from_u64(ct), jnp.asarray(tables), jd,
                                  par, 60, drop_limbs=drop, cross=cross,
                                  engine="s2d"))
    for engine in ("s2d_plain", "plain"):
        got = P.bootstrap(T.from_u64(ct), torch.from_numpy(tables), td, par,
                          60, drop_limbs=drop, cross=cross, engine=engine)
        np.testing.assert_array_equal(T.to_u64(got), want)
    got = P.bootstrap_chunked(T.from_u64(ct), torch.from_numpy(tables), td,
                              par, 60, pbs_batch=5, drop_limbs=drop,
                              cross=cross, engine="s2d_plain")
    np.testing.assert_array_equal(T.to_u64(got), want)


def test_clear_low_bits_s2d_matches_jax_s2d():
    main_ck = KEYS.keygen(TEST_PARAMS, seed=3)
    cfg = ExactRoundingConfig(TEST_PARAMS_K2)
    ak = KEYS.make_aux_server_keys(main_ck, cfg.aux, seed=4,
                                   back_base_log=cfg.back_base_log,
                                   back_levels=cfg.back_levels)
    rng = np.random.default_rng(9)
    n_in, shift = 11, 2
    v = rng.integers(0, 1 << n_in, 12, dtype=np.int64)
    ct = KEYS.encrypt_lwe(main_ck, v.astype(U64) << U64(63 - n_in), rng,
                          key=main_ck.big_lwe_key,
                          noise_log2=TEST_PARAMS.glwe_noise_log2)
    kw = dict(drop_limbs=2, cross=1)
    want = JP.clear_low_bits(JT.from_u64(ct), JP.preprocess_aux_keys(ak),
                             cfg.aux, n_in, shift, cfg.back_base_log,
                             cfg.back_levels, engine="s2d", **kw)
    got = P.clear_low_bits_chunked(T.from_u64(ct), P.preprocess_aux_keys(ak),
                                   cfg.aux, n_in, shift, cfg.back_base_log,
                                   cfg.back_levels, aux_batch=7,
                                   engine="s2d_plain", **kw)
    np.testing.assert_array_equal(T.to_u64(got), JT.to_u64(want))


@pytest.mark.parametrize("k,M", [(1, 8), (2, 13)])
def test_rotate_diff_plain_matches_pallas(k, M):
    acc, amounts, _ = sample_major_inputs(110 + k, k, M)
    jacc = JT.from_u64(acc)
    hi, lo = JK.rotate_diff(jacc.hi, jacc.lo, jnp.asarray(amounts),
                            block_m=M, interpret=True)
    got = K.rotate_diff(T.from_u64(acc), torch.from_numpy(amounts))
    np.testing.assert_array_equal(T.to_u64(got), JT.to_u64(JT.T64(hi, lo)))


def test_s2d_engine_refuses_cpu_tensors():
    acc = torch.zeros((1, N), dtype=torch.int64)
    ms = torch.zeros((1, 3), dtype=torch.int64)
    bsk = torch.zeros((3, 4, 2, 2 * N, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="needs CUDA.*s2d_plain"):
        P.blind_rotate(acc, ms, ms[:, 0], bsk, TEST_PARAMS, engine="s2d")
    kern = torch.zeros((4 * N, 16 * N), dtype=torch.int8)
    with pytest.raises(ValueError, match="not an s2d engine"):
        P.cmux_accumulate_s2d(torch.zeros((1, 2, N), dtype=torch.int64),
                              ms[:, 0], kern, (BLOG, LEVELS, 1, N), 0,
                              engine="plain")
