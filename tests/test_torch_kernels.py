"""The CMUX kernels' plain versions (K1 rotate_decompose, K2 strips in both
layouts, K3 fused_external on the K-major table) against the JAX Pallas
kernels in interpret mode and the JAX conv engine, bit for bit.  The CUDA
kernels are held against these plain versions on the card by
``test_torch_cuda.py``."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dct_cryptonets_tpu.fhe import pallas_kernels as JK
from dct_cryptonets_tpu.fhe import pbs as JP
from dct_cryptonets_tpu.fhe import torus as JT
from dct_cryptonets_tpu_torch.fhe import kernels as K
from dct_cryptonets_tpu_torch.fhe import pbs as P
from dct_cryptonets_tpu_torch.fhe import torus as T
from dct_cryptonets_tpu_torch.fhe.params import TEST_PARAMS

torch.set_num_threads(1)

N, LEVELS, BLOG = 256, 2, 15


def rand_u64(rng, shape):
    x = rng.integers(0, 1 << 63, shape, dtype=np.int64).astype(np.uint64)
    return (x << np.uint64(1)) | rng.integers(0, 2, shape).astype(np.uint64)


def make_inputs(seed, k, M, drop):
    rng = np.random.default_rng(seed)
    J, rows = k + 1, (k + 1) * LEVELS
    acc = rand_u64(rng, (J, M, N))
    amounts = rng.integers(0, 2 * N, M).astype(np.int32)
    amounts[:3] = [0, N, 2 * N - 1]
    bsk_i = rng.integers(-128, 128, (rows, J, 2 * N, 8), dtype=np.int8)
    dB = rng.integers(-128, 128, (2, rows, M, N), dtype=np.int8)
    dB[1] //= 2                       # high digit bytes lie in [-64, 64]
    return acc, amounts, bsk_i, dB


@pytest.mark.parametrize("k,M", [(1, 8), (2, 13)])
def test_rotate_decompose_plain_matches_pallas(k, M):
    acc, amounts, _, _ = make_inputs(10 + k, k, M, 0)
    jacc = JT.from_u64(acc)
    want = JK.rotate_decompose(jacc.hi, jacc.lo, jnp.asarray(amounts), BLOG,
                               LEVELS, 2, block_m=M, interpret=True,
                               plane_major=True)
    got = K.rotate_decompose(T.from_u64(acc), torch.from_numpy(amounts),
                             BLOG, LEVELS)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("k,drop", [(1, 0), (2, 2)])
def test_bigd_strips_plain_matches_pallas_and_xla(k, drop):
    _, _, bsk_i, _ = make_inputs(20 + k, k, 8, drop)
    ref = np.asarray(JP.build_bigd(jnp.asarray(bsk_i), k, LEVELS, N, drop))
    dbl = JP._bigd_rows(jnp.asarray(bsk_i), k, LEVELS, N, drop)
    pallas = np.asarray(JK.build_bigd_strips(dbl, interpret=True))
    t_dbl = P._bigd_rows(torch.from_numpy(bsk_i), k, LEVELS, N, drop)
    np.testing.assert_array_equal(t_dbl.numpy(), np.asarray(dbl))
    got = K.build_bigd_strips(t_dbl).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(
        P.build_bigd(torch.from_numpy(bsk_i), k, LEVELS, N, drop).numpy(), ref)


@pytest.mark.parametrize("k,drop", [(1, 0), (2, 2)])
def test_bigd_strips_k_major_matches_pallas_on_reversed_rows(k, drop):
    """K2 with k_major is the TPU kernel's function on the reversed rows
    rev[i] = dbl[(-i) mod 2N]."""
    _, _, bsk_i, _ = make_inputs(25 + k, k, 8, drop)
    dbl = P._bigd_rows(torch.from_numpy(bsk_i), k, LEVELS, N, drop)
    rev = dbl[:, :, (-torch.arange(2 * N)) % (2 * N)].contiguous()
    want = np.asarray(JK.build_bigd_strips(jnp.asarray(rev.numpy()),
                                           interpret=True))
    got = K.build_bigd_strips(dbl, k_major=True)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        K.build_bigd_strips_plain(dbl, k_major=True).numpy(), want)


@pytest.mark.parametrize("n", [256, 512])
def test_toeplitz_from_k_major_strip_matches_tpu_layout(n):
    """The Toeplitz matrix rebuilt from a K-major strip equals the one
    rebuilt from the TPU layout (rows [128 t0, 128 (t0+1)) are the column
    slice [N - 128(t0+1), 2N - 128(t0+1)) of the strip) and
    T[k, x] = dbl[(x - k) mod 2N]."""
    dbl = torch.from_numpy(np.random.default_rng(n).integers(
        -128, 128, (1, 1, 2 * n), dtype=np.int8))
    tpu = np.asarray(JK.build_bigd_strips(jnp.asarray(dbl.numpy()),
                                          interpret=True))[0, 0]
    want = np.concatenate([tpu[:, n - 128 * (t0 + 1):2 * n - 128 * (t0 + 1)]
                           for t0 in range(n // 128)], axis=0)
    got = K.toeplitz_from_strip(K.build_bigd_strips(dbl, k_major=True)[0, 0])
    np.testing.assert_array_equal(got.numpy(), want)
    kk, xx = np.arange(n)[:, None], np.arange(n)[None, :]
    np.testing.assert_array_equal(want, dbl[0, 0].numpy()[(xx - kk) % (2 * n)])


@pytest.mark.parametrize("k,drop,cross,M", [(1, 0, 0, 13), (2, 2, 1, 8),
                                            (1, 2, 1, 8), (2, 0, 0, 13)])
def test_fused_external_plain_matches_pallas(k, drop, cross, M):
    """K3's plain version on the K-major table == the TPU kernel on its own
    table."""
    acc, _, bsk_i, dB = make_inputs(30 + k, k, M, drop)
    bigd = JP.build_bigd(jnp.asarray(bsk_i), k, LEVELS, N, drop)
    jacc = JT.from_u64(acc)
    hi, lo = JK.fused_external(jnp.asarray(dB[0]), jnp.asarray(dB[1]), bigd,
                               jacc.hi, jacc.lo, drop, cross, block_m=M,
                               interpret=True)
    strips = K.build_bigd_strips(
        P._bigd_rows(torch.from_numpy(bsk_i), k, LEVELS, N, drop),
        k_major=True)
    got = K.fused_external(torch.from_numpy(dB[0]), torch.from_numpy(dB[1]),
                           strips, T.from_u64(acc), drop, cross)
    np.testing.assert_array_equal(T.to_u64(got),
                                  JT.to_u64(JT.T64(hi, lo)))


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("drop", [0, 2])
@pytest.mark.parametrize("cross", [0, 1])
@pytest.mark.parametrize("M", [8, 13])
def test_cmux_step_matches_jax_conv_engine(k, drop, cross, M):
    """strips -> K1 -> K3 (the port's CMUX step) == one JAX conv-engine
    CMUX step (`pbs.cmux_accumulate`) on the same accumulator and key."""
    acc, amounts, bsk_i, _ = make_inputs(40 + k + drop + cross + M, k, M,
                                         drop)
    jacc = JT.from_u64(np.ascontiguousarray(acc.transpose(1, 0, 2)))
    kern = JP.expand_bsk_kernel(jnp.asarray(bsk_i), k, LEVELS, N, drop)
    want = JP.cmux_accumulate(jacc, jnp.asarray(amounts), kern,
                              (BLOG, LEVELS, k, N), drop, cross)
    tacc = T.from_u64(acc)
    strips = K.build_bigd_strips(
        P._bigd_rows(torch.from_numpy(bsk_i), k, LEVELS, N, drop),
        k_major=True)
    dB0, dB1 = K.rotate_decompose(tacc, torch.from_numpy(amounts), BLOG,
                                  LEVELS)
    got = K.fused_external(dB0, dB1, strips, tacc, drop, cross)
    np.testing.assert_array_equal(T.to_u64(got.transpose(0, 1)),
                                  JT.to_u64(want))


def test_wrappers_count_no_launch_on_cpu():
    K.reset_launch_counts()
    acc, amounts, bsk_i, dB = make_inputs(50, 1, 8, 0)
    tacc = T.from_u64(acc)
    K.rotate_decompose(tacc, torch.from_numpy(amounts), BLOG, LEVELS)
    o = torch.zeros((8, 16, N), dtype=torch.int32)
    K.combine_accumulate(o, o, tacc.transpose(0, 1), 0)
    K.rotate_diff(tacc.transpose(0, 1), torch.from_numpy(amounts))
    assert K.launch_counts() == {"rotate_decompose": 0,
                                 "build_bigd_strips": 0, "fused_external": 0,
                                 "combine_accumulate": 0, "rotate_diff": 0}


def test_kernel_engine_refuses_cpu_tensors():
    acc = torch.zeros((1, N), dtype=torch.int64)
    ms = torch.zeros((1, 3), dtype=torch.int64)
    bsk = torch.zeros((3, 4, 2, 2 * N, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="needs CUDA"):
        P.blind_rotate(acc, ms, ms[:, 0], bsk, TEST_PARAMS, engine="kernel")
