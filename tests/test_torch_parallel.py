"""The port's meshes and sharded paths against the JAX package on the
CPU: the mesh helpers, a sharded bootstrap, ``forward(fhe="execute",
mesh=...)`` with a remainder batch and the slip audit, and the
tile-sharded DCT ingest.  The JAX side runs on the 8-device CPU mesh of
``tests/conftest.py``; the port's CPU meshes repeat the CPU device.

The sharded ingest equals the port's own ``dct_ingest`` bit for bit; it
is held to JAX's ``dct_ingest_sharded`` at ``tests/test_torch_codec.py``'s
atol 1e-4, as the unsharded ingests are (the float DCT sums in another
order, and the normalization lands an ulp away at filter size 8)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dct_cryptonets_tpu.data import CodecConfig as JCodec
from dct_cryptonets_tpu.data import dct_ingest_sharded as j_ingest_sharded
from dct_cryptonets_tpu.fhe import keys as KEYS
from dct_cryptonets_tpu.fhe import pbs as JP
from dct_cryptonets_tpu.fhe import torus as JT
from dct_cryptonets_tpu.fhe.keys import Csprng
from dct_cryptonets_tpu.fhe.params import TEST_PARAMS
from dct_cryptonets_tpu.parallel import data_mesh as j_data_mesh
from dct_cryptonets_tpu.parallel import replicate as j_replicate
from dct_cryptonets_tpu.parallel import shard_batch as j_shard_batch
from dct_cryptonets_tpu_torch.data import (CodecConfig, dct_ingest,
                                           dct_ingest_sharded)
from dct_cryptonets_tpu_torch.fhe import pbs as P
from dct_cryptonets_tpu_torch.fhe import torus as T
from dct_cryptonets_tpu_torch.parallel import (data_mesh, replicate,
                                               shard_batch)
from dct_cryptonets_tpu_torch.parallel.mesh import run_sharded
from test_torch_runtime import compile_both, jax_params, specs

torch.set_num_threads(1)
CPU = torch.device("cpu")


def test_shard_batch_places_on_devices():
    """Mirrors ``test_sharding.py::test_shard_batch_places_on_devices``:
    8 shards of a 16-row batch, gathered back to the batch JAX's sharded
    array holds, and one replicated copy shared by the 8 CPU entries."""
    mesh = data_mesh(8, devices="cpu")
    assert mesh.size == 8 and mesh.shape == (8,)
    assert mesh.axis_names == ("data",) and mesh.local() == list(range(8))
    x = np.arange(16 * 4, dtype=np.float32).reshape(16, 4)
    xs = shard_batch(mesh, x)
    assert [tuple(s.shape) for _, s in xs.local()] == [(2, 4)] * 8
    assert all(s.device == CPU for s in xs.shards)
    want = np.asarray(j_shard_batch(j_data_mesh(8), x))
    np.testing.assert_array_equal(xs.gather().numpy(), want)
    r = replicate(mesh, {"a": np.ones(3)})
    jr = j_replicate(j_data_mesh(8), {"a": np.ones(3)})
    assert len(r) == 8 and all(c is r[0] for c in r)
    np.testing.assert_array_equal(r[0]["a"].numpy(), np.asarray(jr["a"]))


def test_mesh_errors(monkeypatch):
    """A length the mesh does not divide raises (as ``NamedSharding``
    does), and a mesh needs a GPU unless CPU devices are asked for."""
    with pytest.raises(ValueError, match="does not divide"):
        shard_batch(data_mesh(3, devices="cpu"), np.zeros((16, 2)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        data_mesh(2)


def test_one_entry_mesh_on_the_module_device_copies_nothing():
    """``shard_over`` a one-entry mesh on the module's device shares the
    module's key tensors: the mesh path costs no key copy there."""
    jspec, spec = specs((4,), 4, (1,))
    _, tm = compile_both(jspec, spec, *jax_params(jspec, 0), "approximate")
    tm.keygen(seed=6)
    tm.shard_over(data_mesh(1, devices=tm.device))
    dk, ak = tm.replicas[1][0]
    assert ak is None and all(
        a is b for a, b in zip(dk, tm.device_keys))
    with pytest.raises(ValueError, match="shard_over"):
        tm.forward(np.zeros((2, 4, 4, 3), np.float32), fhe="execute",
                   mesh=data_mesh(2, devices="cpu"))


def test_sharded_bootstrap_matches_jax():
    """Mirrors ``test_sharding.py::test_sharded_pbs_batch``: a bootstrap
    over an 8-entry mesh, keys replicated, equals JAX's sharded bootstrap
    on its 8-device mesh and the port's unsharded one, bit for bit."""
    ck = KEYS.keygen(TEST_PARAMS, seed=0)
    sk = KEYS.make_server_keys(ck, seed=1)
    rng = np.random.default_rng(2)
    bits, M = 3, 16
    msgs = rng.integers(0, 2 ** bits, M)
    ct = KEYS.encrypt_lwe(ck, msgs.astype(np.uint64) << np.uint64(
        64 - bits - 1), rng, key=ck.big_lwe_key,
        noise_log2=TEST_PARAMS.glwe_noise_log2)
    tables = np.tile(np.arange(2 ** bits, dtype=np.int32), (M, 1))
    out_delta = 64 - bits - 1

    jmesh = j_data_mesh(8)
    jct = JT.T64(*j_shard_batch(jmesh, list(JT.from_u64(ct))))
    jdsk = JP.DeviceServerKeys(*j_replicate(
        jmesh, list(JP.preprocess_server_keys(sk))))
    want = JT.to_u64(JP.bootstrap(jct, j_shard_batch(
        jmesh, jnp.asarray(tables)), jdsk, TEST_PARAMS, out_delta))

    mesh = data_mesh(8, devices="cpu")
    dsk = P.preprocess_server_keys(sk)
    ct_s, tab_s = shard_batch(mesh, (T.from_u64(ct), torch.as_tensor(tables)))
    out = run_sharded(mesh, lambda c, t, k: P.bootstrap(
        c, t, k, TEST_PARAMS, out_delta), ct_s, tab_s, replicate(mesh, dsk))
    got = T.to_u64(out.gather())
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, T.to_u64(P.bootstrap(
        T.from_u64(ct), torch.as_tensor(tables), dsk, TEST_PARAMS,
        out_delta)))


def test_forward_execute_on_a_mesh_with_a_remainder_batch():
    """Mirrors ``test_sharding.py::test_module_level_sharded_execute``:
    ``forward(fhe="execute", mesh=data_mesh(8))`` on a batch of 5 pads it
    to 8, and its features equal the JAX module's execute of the padded
    batch (same keygen seed, same Csprng) cut back to 5, bit for bit; with
    ``check_ref`` its slip counts are the unsharded run's."""
    jspec, spec = specs((4,), 4, (1,))
    jm, tm = compile_both(jspec, spec, *jax_params(jspec, 0), "approximate")
    jm.keygen(seed=6)
    tm.keygen(seed=6)
    x = np.clip(np.random.default_rng(5).normal(0, 0.7, (5, 4, 4, 3)),
                -2, 2).astype(np.float32)
    x_pad = np.concatenate([x, np.repeat(x[-1:], 3, axis=0)], axis=0)
    want = jm.forward(x_pad, fhe="execute", enc_rng=Csprng(9))[:5]

    ref = tm.forward(x_pad, fhe="execute", enc_rng=Csprng(9),
                     check_ref=True)[:5]
    ref_stats = dict(tm.stats)
    mesh = data_mesh(8, devices="cpu")
    tm.shard_over(mesh)
    got = tm.forward(x, fhe="execute", mesh=mesh, enc_rng=Csprng(9),
                     check_ref=True)
    assert got.shape == (5, want.shape[1])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, tm.forward(x, fhe="simulate"))
    for key in ("pbs_executed", "tlu_slips", "tlu_sites", "tlu_slip_detail",
                "pbs_per_sample"):
        assert tm.stats[key] == ref_stats[key], key
    assert tm.stats["pbs_executed"] == 8 * tm.circuit.num_pbs
    for key in ("execute_time", "pbs_time", "pbs_per_sec"):
        assert tm.stats[key] > 0


def _images(b, size, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (b, size, size, 3), np.uint8)


@pytest.mark.parametrize("fs,b,size,seed,n_mesh", [
    (4, 1, 80, 1, 8),        # flagship: the resize prologue, B=1
    (4, 4, 80, 4, 8),
    (8, 2, 144, 7, 8),       # libjpeg integer path
    (4, 1, 80, 3, 3),        # 256 tiles on a 3-entry mesh: padded
])
def test_dct_ingest_sharded_matches_unsharded_and_jax(fs, b, size, seed,
                                                      n_mesh):
    """The cases of ``test_dct_tile_sharding.py``: the sharded ingest
    equals the port's ``dct_ingest`` bit for bit, and JAX's
    ``dct_ingest_sharded`` on its mesh to atol 1e-4."""
    cfg = CodecConfig(channels=24, filter_size=fs, image_size_dct=16)
    imgs = _images(b, size, seed)
    got = dct_ingest_sharded(imgs, cfg, data_mesh(n_mesh, devices="cpu"))
    np.testing.assert_array_equal(got.numpy(), dct_ingest(imgs, cfg).numpy())
    want = np.asarray(j_ingest_sharded(jnp.asarray(imgs), JCodec(
        channels=24, filter_size=fs, image_size_dct=16), j_data_mesh(n_mesh)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
