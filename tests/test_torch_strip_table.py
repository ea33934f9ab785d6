"""The precomputed extraction strip table and the rest of the PBS surface
that came with it, against the JAX package bit for bit at the tiny test
parameter sets: ``precompute_bigd_strips`` (the JAX table via Pallas in
interpret mode, each strip read backwards along both axes in the port's
K-major layout), a blind rotate fed from the table (the port's plain
engine against JAX ``engine="fused"``), ``clear_low_bits`` with and
without a table, ``with_precomputed_strips``' gate, keygen attaching the
table and the whole slice's ciphertexts with it, ``safe_drop_limbs`` and
the TPU package's engine names."""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dct_cryptonets_tpu.fhe import keys as KEYS
from dct_cryptonets_tpu.fhe import params as JPAR
from dct_cryptonets_tpu.fhe import pbs as JP
from dct_cryptonets_tpu.fhe import torus as JT
from dct_cryptonets_tpu.fhe.keys import Csprng
from dct_cryptonets_tpu.fhe.params import (TEST_PARAMS, TEST_PARAMS_K2,
                                           ExactRoundingConfig)
from dct_cryptonets_tpu_torch.fhe import kernels as K
from dct_cryptonets_tpu_torch.fhe import params as PAR
from dct_cryptonets_tpu_torch.fhe import pbs as P
from dct_cryptonets_tpu_torch.fhe import runtime as R
from dct_cryptonets_tpu_torch.fhe import torus as T
from dct_cryptonets_tpu_torch.parallel import data_mesh, replicate
from test_torch_runtime import XQ, compile_both, jax_params, specs

torch.set_num_threads(1)
U64 = np.uint64
PARS = {"k1": TEST_PARAMS, "k2": TEST_PARAMS_K2}


def random_bsk(par, n, seed):
    """(n, rows, k+1, 2N, 8) random int8 key byte limbs."""
    k, N = par.glwe_dim, par.poly_size
    return np.random.default_rng(seed).integers(
        -128, 128, (n, (k + 1) * par.pbs_levels, k + 1, 2 * N, 8),
        dtype=np.int8)


@pytest.mark.parametrize("name", ["k1", "k2"])
@pytest.mark.parametrize("drop", [0, 3])
def test_precompute_bigd_strips_matches_jax(name, drop):
    par = PARS[name]
    k, N, levels = par.glwe_dim, par.poly_size, par.pbs_levels
    bsk = random_bsk(par, 3, 1 + drop)
    want = np.asarray(JP.precompute_bigd_strips(jnp.asarray(bsk), k, levels,
                                                N, drop))
    got = P.precompute_bigd_strips(torch.from_numpy(bsk), k, levels, N, drop)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.flip(-2, -1).numpy(), want)
    for i in range(3):           # what the fused engine's step i builds
        assert torch.equal(got[i], K.build_bigd_strips_plain(
            P._bigd_rows(torch.from_numpy(bsk[i]), k, levels, N, drop),
            k_major=True))


def encrypted_rotate_inputs(par, M, seed):
    rng = np.random.default_rng(seed)
    N, n = par.poly_size, par.lwe_dim
    test = rng.integers(0, 1 << 63, (M, N)).astype(U64)
    ct_a = rng.integers(0, 2 * N, (M, n))
    ct_b = rng.integers(0, 2 * N, (M,))
    return test, ct_a, ct_b


@pytest.mark.parametrize("name,drop,cross", [("k1", 0, 0), ("k2", 3, 1)])
def test_blind_rotate_from_the_table_matches_jax_fused(name, drop, cross):
    par = PARS[name]
    k, N, levels, n = (par.glwe_dim, par.poly_size, par.pbs_levels,
                       par.lwe_dim)
    bsk = random_bsk(par, n, 7 + drop)
    test, ct_a, ct_b = encrypted_rotate_inputs(par, 8, 8 + drop)
    jbsk = jnp.asarray(bsk)
    want = JP.blind_rotate(
        JT.from_u64(test), jnp.asarray(ct_a, jnp.uint32),
        jnp.asarray(ct_b, jnp.uint32), jbsk, par, drop, cross,
        engine="fused",
        bigd_all=JP.precompute_bigd_strips(jbsk, k, levels, N, drop))
    tbsk = torch.from_numpy(bsk)
    table = P.precompute_bigd_strips(tbsk, k, levels, N, drop)
    args = (T.from_u64(test), torch.from_numpy(ct_a), torch.from_numpy(ct_b),
            tbsk, par, drop, cross)
    got = P.blind_rotate(*args, engine="plain", bigd_all=table)
    np.testing.assert_array_equal(T.to_u64(got), JT.to_u64(want))
    assert torch.equal(got, P.blind_rotate(*args, engine="plain"))
    with pytest.raises(ValueError, match="drop_limbs"):
        P.blind_rotate(*args[:5], drop + 1, cross, bigd_all=table)


@pytest.fixture(scope="module")
def aux_material():
    main_ck = KEYS.keygen(TEST_PARAMS, seed=3)
    cfg = ExactRoundingConfig(TEST_PARAMS_K2)
    ak = KEYS.make_aux_server_keys(main_ck, cfg.aux, seed=4,
                                   back_base_log=cfg.back_base_log,
                                   back_levels=cfg.back_levels)
    return main_ck, cfg, JP.preprocess_aux_keys(ak), P.preprocess_aux_keys(ak)


@pytest.mark.parametrize("drop,cross,fwd,back,keep", [
    (0, 0, 0, 0, 0), (2, 1, 2, 2, 1)])
def test_clear_low_bits_with_a_table_equals_without(aux_material, drop, cross,
                                                    fwd, back, keep):
    main_ck, cfg, jak, tak = aux_material
    aux = cfg.aux
    n_in, shift = 11, 3
    rng = np.random.default_rng(20 + drop)
    v = rng.integers(0, 1 << n_in, 12)
    ct = KEYS.encrypt_lwe(main_ck, v.astype(U64) << U64(63 - n_in), rng,
                          key=main_ck.big_lwe_key,
                          noise_log2=TEST_PARAMS.glwe_noise_log2)
    with_table = tak._replace(bigd_bytes=P.precompute_bigd_strips(
        tak.bsk_bytes, aux.glwe_dim, aux.pbs_levels, aux.poly_size, drop))
    kw = dict(drop_limbs=drop, cross=cross, fwd_ks_drop=fwd,
              back_ks_drop=back, keep_low=keep)
    rest = (aux, n_in, shift, cfg.back_base_log, cfg.back_levels)
    want = JP.clear_low_bits(JT.from_u64(ct), jak, *rest, **kw)
    got = P.clear_low_bits(T.from_u64(ct), with_table, *rest, **kw)
    np.testing.assert_array_equal(T.to_u64(got), JT.to_u64(want))
    assert torch.equal(got, P.clear_low_bits(T.from_u64(ct), tak, *rest,
                                             **kw))
    chunked = P.clear_low_bits_chunked(T.from_u64(ct), with_table, *rest,
                                       aux_batch=5, **kw)
    assert torch.equal(chunked, got)


class Built(Exception):
    """Raised by the stand-in table builder with its arguments."""


def test_with_precomputed_strips_gate(aux_material, monkeypatch):
    """No table on the CPU, for N > 512 or over ``max_bytes`` (default
    ``DCTC_STRIP_TABLE_BYTES``, else 2 GiB); the size is the JAX
    package's formula."""
    _, cfg, _, tak = aux_material
    aux = cfg.aux
    assert P.with_precomputed_strips(tak, aux, 0, max_bytes=2 ** 40) is tak

    def build(bsk, k, levels, N, drop):
        raise Built(tuple(bsk.shape), k, levels, N, drop)
    monkeypatch.setattr(P, "precompute_bigd_strips", build)

    def on_card(n, k, levels, N):            # shapes only, no storage
        rows = (k + 1) * levels
        return P.DeviceAuxKeys(torch.empty((n, rows, k + 1, 2 * N, 8),
                                           dtype=torch.int8, device="meta"),
                               tak.ksk_fwd_bytes, tak.ksk_back_bytes)
    # the flagship's extraction lattice, k2n512f: 6.34 GB at drop 2
    k2n512f = PAR.EXTRACT_PRESETS["k2n512f"]
    flag = on_card(512, 2, k2n512f.pbs_levels, 512)
    size = P.strip_table_bytes(flag, 2)
    assert size == 512 * 3 * (8 - 2) * 6 * 128 * (1024 - 128) == 6341787648
    monkeypatch.delenv("DCTC_STRIP_TABLE_BYTES", raising=False)
    assert P.with_precomputed_strips(flag, k2n512f, 2) is flag
    assert P.with_precomputed_strips(flag, k2n512f, 2, size - 1) is flag
    with pytest.raises(Built) as e:
        P.with_precomputed_strips(flag, k2n512f, 2, max_bytes=size)
    assert e.value.args == ((512, 6, 3, 1024, 8), 2, 2, 512, 2)
    monkeypatch.setenv("DCTC_STRIP_TABLE_BYTES", str(size))
    with pytest.raises(Built):
        P.with_precomputed_strips(flag, k2n512f, 2)
    monkeypatch.setenv("DCTC_STRIP_TABLE_BYTES", str(size - 1))
    assert P.with_precomputed_strips(flag, k2n512f, 2) is flag
    # the main lattice (N = 2048) never takes one
    big = on_card(4, 1, 2, 1024)
    main = dataclasses.replace(k2n512f, poly_size=1024, glwe_dim=1)
    assert P.with_precomputed_strips(big, main, 0, max_bytes=2 ** 40) is big


def test_keygen_attaches_the_table_and_the_slice_matches_jax(monkeypatch):
    """``keygen`` asks for the table at the chosen extraction drop; with
    a table attached (built here on the CPU, where the gate builds none),
    the encrypted run gives the JAX package's ciphertexts."""
    jspec, spec = specs((4,), 4, (1,))
    jp, js, p, s = jax_params(jspec, 0)
    jm, tm = compile_both(jspec, spec, jp, js, p, s, "exact")
    tm.pbs_batch, tm.aux_batch = 16, 48
    asked = []

    def attach(ak, aux, drop):
        asked.append(drop)
        return ak._replace(bigd_bytes=P.precompute_bigd_strips(
            ak.bsk_bytes, aux.glwe_dim, aux.pbs_levels, aux.poly_size, drop))
    monkeypatch.setattr(R, "with_precomputed_strips", attach)
    tm.keygen(seed=5)
    assert asked == [tm.aux_drop_limbs] == [0]
    assert tm.aux_keys.bigd_bytes is not None
    jm.keygen(seed=5)
    assert jm.aux_keys.bigd_bytes is None            # the CPU gate
    ct = tm.encrypt(XQ, rng=Csprng(9))
    want = jm.run_encrypted(jm.encrypt(XQ, rng=Csprng(9)))
    np.testing.assert_array_equal(T.to_u64(tm.run_encrypted(ct)),
                                  JT.to_u64(want))


@pytest.mark.parametrize("with_table", [False, True])
def test_replicate_carries_the_optional_table(aux_material, with_table):
    _, cfg, _, tak = aux_material
    aux = cfg.aux
    if with_table:
        tak = tak._replace(bigd_bytes=P.precompute_bigd_strips(
            tak.bsk_bytes, aux.glwe_dim, aux.pbs_levels, aux.poly_size, 1))
    for copy in replicate(data_mesh(2, devices="cpu"), tak):
        assert type(copy) is P.DeviceAuxKeys
        for a, b in zip(copy, tak):
            assert (a is None and b is None) or torch.equal(a, b)


def test_safe_drop_limbs_matches_jax():
    sets = [JPAR.params_for_precision(b) for b in range(1, 9)]
    sets += list(JPAR.EXTRACT_PRESETS.values()) + [TEST_PARAMS,
                                                   TEST_PARAMS_K2]
    seen = set()
    for par in sets:
        for bits in range(1, 9):
            for kw in ({}, {"p_error": 1e-3, "amplification2": 2.0 ** 8}):
                got = PAR.safe_drop_limbs(par, bits, **kw)
                assert got == JPAR.safe_drop_limbs(par, bits, **kw)
                seen.add(got)
    assert len(seen) > 1


def test_tpu_engine_names_give_the_jax_engines_bits():
    par = TEST_PARAMS
    ck = KEYS.keygen(par, seed=3)
    sk = KEYS.make_server_keys(ck, seed=4)
    rng = np.random.default_rng(30)
    msgs = rng.integers(0, 8, 8)
    ct = KEYS.encrypt_lwe(ck, msgs.astype(U64) << U64(60), rng,
                          key=ck.big_lwe_key, noise_log2=par.glwe_noise_log2)
    tables = rng.integers(-4, 4, (8, 8)).astype(np.int32)
    want = JP.bootstrap(JT.from_u64(ct), jnp.asarray(tables),
                        JP.preprocess_server_keys(sk), par, 60, 2, 1,
                        engine="conv")
    tsk = P.preprocess_server_keys(sk)
    got = P.bootstrap(T.from_u64(ct), torch.from_numpy(tables), tsk, par, 60,
                      2, 1, engine="conv")
    np.testing.assert_array_equal(T.to_u64(got), JT.to_u64(want))
    with pytest.raises(ValueError, match="engine='fused' needs CUDA.*"
                                         "engine='plain'"):
        P.bootstrap(T.from_u64(ct), torch.from_numpy(tables), tsk, par, 60,
                    engine="fused")
    with pytest.raises(ValueError, match="unknown engine"):
        P.bootstrap(T.from_u64(ct), torch.from_numpy(tables), tsk, par, 60,
                    engine="xla")
