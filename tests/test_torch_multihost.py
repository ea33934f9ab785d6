"""The port's multi-process path on the CPU: two processes joined by
``torch.distributed`` (gloo), each modelling one host with two CPU mesh
entries, the counterpart of ``tests/test_multihost.py``.

The workers (this file run as a script) run ``initialize``,
``host_chip_mesh`` and ``local_batch_to_global``; a train-mode forward and
one data-parallel train step (augmentation and dropout on, float64) whose
BatchNorm statistics, loss and gradients are all-reduced across the
processes; and one encrypted ``TEST_PARAMS`` batch sharded over the 2 x 2
mesh under server keys that rank 0 broadcasts (``shard_over``).  The
tests hold their results against the one-process port and the JAX
package on the same seeded inputs.  Each worker and each collective has
its own timeout, so a hang fails the test instead of stalling the run.

Usage (worker): python test_torch_multihost.py <host:port> <n> <rank> <dir>
"""
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT = 45        # seconds a worker may take
COLLECTIVE_TIMEOUT = 30    # seconds a rendezvous or collective may take
# the small QAT net of tests/test_torch_train.py on the DCT input
SMALL_KW = dict(name="smallqat", block_counts=(1, 1), widths=(4, 8),
                in_channels=24, img_size=8, num_classes=5, bit_width=4,
                quantized=True)
BATCH, BITS = 8, 3
MODULE_STATS = ("pbs_executed", "tlu_slips", "tlu_sites", "tlu_slip_detail")


def small_spec():
    from dct_cryptonets_tpu_torch.models.resnet import ModelSpec
    from dct_cryptonets_tpu_torch.models.topology import StemSpec
    return ModelSpec(**SMALL_KW, stem_override=StemSpec(1, 1, 0, None, None,
                                                        4, True))


def codec():
    from dct_cryptonets_tpu_torch.data.codec import CodecConfig
    return CodecConfig(24, 4, 8)


def step_cfg():
    import types
    return types.SimpleNamespace(optimizer="adam", weight_decay=1e-5,
                                 momentum=0.9, grad_clip_value=None,
                                 grad_clip_norm=1.0, dropout=0.1)


def tree_leaves(tree):
    from dct_cryptonets_tpu_torch.models.resnet import tree_leaves
    return tree_leaves(tree)


def train_step(params, state, images, labels, rows=None, group=None):
    """One float64 Adam step on the augmented batch (generator 1234, as
    the trainer's); with ``rows`` and ``group``, this process's rows of a
    data-parallel step.  Returns (loss, params, state, global logits)."""
    from dct_cryptonets_tpu_torch import train as TRAIN
    from dct_cryptonets_tpu_torch.data.codec import dct_ingest_train
    from dct_cryptonets_tpu_torch.models.resnet import QATResNet

    gen = torch.Generator().manual_seed(1234)
    x = dct_ingest_train(gen, images, codec(), rows).double()
    y = torch.as_tensor(labels.astype(np.int64))
    model = QATResNet.from_params(params, state, small_spec()).double()
    shard = None
    if group is not None:
        model.data_parallel(group)
        y, shard = y[rows], (rows, len(labels))
    cfg = step_cfg()
    opt = TRAIN.make_optimizer(cfg, 1e-3, model.parameters())
    loss, logits = TRAIN.train_step(model, opt, cfg, x, y, gen, shard)
    return (float(loss), *model.to_params(), logits.numpy())


def train_forward(params, state, images, rows=None, group=None):
    """A float64 train-mode forward on the eval ingest: (this process's
    logits, the new BatchNorm state)."""
    from dct_cryptonets_tpu_torch.data.codec import dct_ingest
    from dct_cryptonets_tpu_torch.models.resnet import QATResNet

    x = dct_ingest(images, codec()).double()
    model = QATResNet.from_params(params, state, small_spec()).double()
    if group is not None:
        model.data_parallel(group)
        x = x[rows]
    with torch.no_grad():
        _, logits = model(x)
    return logits.numpy(), model.to_params()[1]


def ciphertexts():
    """The client's TEST_PARAMS keys (seed 0) and a batch of fresh
    ciphertexts of BITS-bit messages (Csprng 2)."""
    from dct_cryptonets_tpu_torch.fhe.keys import (Csprng, encrypt_lwe,
                                                   keygen)
    from dct_cryptonets_tpu_torch.fhe.params import TEST_PARAMS
    ck = keygen(TEST_PARAMS, seed=0)
    msgs = np.arange(BATCH) % (2 ** BITS)
    mu = msgs.astype(np.uint64) << np.uint64(64 - BITS - 1)
    ct = encrypt_lwe(ck, mu, Csprng(2), key=ck.big_lwe_key,
                     noise_log2=TEST_PARAMS.glwe_noise_log2)
    return ck, msgs, ct


def worker(address, n_proc, pid, outdir):
    import torch.distributed as dist

    from dct_cryptonets_tpu_torch.fhe import pbs as P
    from dct_cryptonets_tpu_torch.fhe import torus as T
    from dct_cryptonets_tpu_torch.fhe.keys import (Csprng, decrypt_lwe,
                                                   make_server_keys)
    from dct_cryptonets_tpu_torch.fhe.params import TEST_PARAMS
    from dct_cryptonets_tpu_torch.fhe.runtime import CompiledModule
    from dct_cryptonets_tpu_torch.parallel import (host_chip_mesh, initialize,
                                                   local_batch_to_global)
    from dct_cryptonets_tpu_torch.parallel.distributed import shutdown
    from dct_cryptonets_tpu_torch.parallel.mesh import run_sharded

    torch.set_num_threads(1)
    backend = initialize(address, n_proc, pid, devices=["cpu", "cpu"],
                         timeout=COLLECTIVE_TIMEOUT)
    with open(os.path.join(outdir, "inputs.pkl"), "rb") as fh:
        inp = pickle.load(fh)
    mesh = host_chip_mesh()
    out = {"backend": backend, "mesh_shape": mesh.shape,
           "axis_names": mesh.axis_names, "ranks": mesh.ranks,
           "local": mesh.local()}
    per = BATCH // n_proc
    rows = slice(pid * per, (pid + 1) * per)
    group = dist.group.WORLD

    out["forward"] = train_forward(inp["params"], inp["state"],
                                   inp["images"], rows, group)
    out["step"] = train_step(inp["params"], inp["state"], inp["images"],
                             inp["labels"], rows, group)

    # the encrypted batch: rank 0 alone makes the server keys, shard_over
    # broadcasts them; each process passes its rows of the batch
    ck, msgs, ct = ciphertexts()
    module = CompiledModule(None, TEST_PARAMS, device="cpu")
    if pid == 0:
        module.device_keys = P.preprocess_server_keys(
            make_server_keys(ck, seed=1))
    module.shard_over(mesh)
    tables = np.tile(np.arange(2 ** BITS, dtype=np.int32), (BATCH, 1))
    ct_s, tab_s = local_batch_to_global(
        mesh, (T.from_u64(ct[rows]), torch.as_tensor(tables[rows])))
    out["shard_len"] = [len(s) if s is not None else None
                        for s in ct_s.shards]
    res = run_sharded(mesh, lambda c, t, keys: P.bootstrap(
        c, t, keys[0], TEST_PARAMS, 64 - BITS - 1), ct_s, tab_s,
        module.replicas[1])
    full = T.to_u64(res.gather())
    phase = decrypt_lwe(ck, full, key=ck.big_lwe_key)
    shift = np.uint64(64 - BITS - 1)
    with np.errstate(over="ignore"):
        dec = ((phase + (np.uint64(1) << (shift - np.uint64(1)))) >> shift) \
            & np.uint64((1 << (BITS + 1)) - 1)
    out["decrypted"], out["msgs"], out["bootstrapped"] = dec, msgs, full

    # the module's sharded forward across the processes: every rank holds
    # the client keys (the same keygen seed) and rank 0's server keys
    module = inp["module"]
    module.keygen(seed=6)
    module.shard_over(mesh)
    feats = module.forward(inp["x"], fhe="execute", mesh=mesh,
                           enc_rng=Csprng(9), check_ref=True)
    out["module"] = (feats, {k: module.stats[k] for k in MODULE_STATS})
    with open(os.path.join(outdir, f"rank{pid}.pkl"), "wb") as fh:
        pickle.dump(out, fh)
    shutdown()


# ---------------------------------------------------------------------------
# the tests (the parent process)

torch.set_num_threads(1)


def run_world(outdir, n_proc=2):
    from dct_cryptonets_tpu_torch.parallel.distributed import free_port
    address = f"127.0.0.1:{free_port()}"
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), address,
         str(n_proc), str(pid), str(outdir)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in range(n_proc)]
    t0 = time.time()
    logs = []
    try:
        for p in procs:
            left = max(1.0, WORKER_TIMEOUT - (time.time() - t0))
            logs.append(p.communicate(timeout=left)[0].decode(
                errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {pid} failed:\n{log[-3000:]}"
    outs = []
    for pid in range(n_proc):
        with open(os.path.join(outdir, f"rank{pid}.pkl"), "rb") as fh:
            outs.append(pickle.load(fh))
    return outs, logs


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Seeded inputs (a calibrated init of the small net, 8 images and
    labels; the runtime tests' tiny module, compiled for ``TEST_PARAMS``,
    and 3 inputs) written for both workers, then their results."""
    from dct_cryptonets_tpu_torch.data.codec import dct_ingest
    from dct_cryptonets_tpu_torch.models.resnet import (calibrate_scales,
                                                        init_model)
    from test_torch_runtime import compile_both, jax_params, specs
    outdir = tmp_path_factory.mktemp("world")
    rng = np.random.default_rng(0)
    images, calib = rng.integers(0, 256, (2, BATCH, 32, 32, 3),
                                 dtype=np.uint8)
    labels = rng.integers(0, 5, BATCH)
    spec = small_spec()
    params, state = init_model(spec, torch.Generator().manual_seed(0))
    params = calibrate_scales(params, state, dct_ingest(calib, codec()),
                              spec)
    jspec, tspec = specs((4,), 4, (1,))
    _, module = compile_both(jspec, tspec, *jax_params(jspec, 0),
                             "approximate")
    x = np.clip(np.random.default_rng(5).normal(0, 0.7, (3, 4, 4, 3)),
                -2, 2).astype(np.float32)
    inp = {"params": params, "state": state, "images": images,
           "labels": labels, "module": module, "x": x}
    with open(outdir / "inputs.pkl", "wb") as fh:
        pickle.dump(inp, fh)
    outs, logs = run_world(outdir)
    return inp, outs, logs


def test_mesh_layout_and_backend(world):
    _, outs, logs = world
    for pid, o in enumerate(outs):
        assert o["backend"] == "gloo"
        assert o["mesh_shape"] == (2, 2)
        assert o["axis_names"] == ("host", "chip")
        assert o["ranks"] == (0, 0, 1, 1)
        assert o["local"] == [2 * pid, 2 * pid + 1]
        # local_batch_to_global: 4 local rows over 2 local entries
        want = [None] * 4
        want[2 * pid] = want[2 * pid + 1] = 2
        assert o["shard_len"] == want
        assert "backend gloo" in logs[pid]


def test_sharded_train_step_equals_one_process_step(world):
    """Loss, parameters and BatchNorm state after one data-parallel
    Adam step over two processes equal the one-process step within
    1e-9 (float64), and equal each other on both ranks."""
    inp, outs, _ = world
    loss, params, state, logits = train_step(
        inp["params"], inp["state"], inp["images"], inp["labels"])
    for o in outs:
        g_loss, g_params, g_state, g_logits = o["step"]
        assert abs(g_loss - loss) < 1e-9
        np.testing.assert_allclose(g_logits, logits, rtol=0, atol=1e-9)
        for g, w in zip(tree_leaves((g_params, g_state)),
                        tree_leaves((params, state))):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-9)
    for a, b in zip(tree_leaves(outs[0]["step"]),
                    tree_leaves(outs[1]["step"])):
        np.testing.assert_array_equal(a, b)


def test_sharded_train_forward_matches_unsharded_and_jax(world):
    """The train-mode forward with BatchNorm statistics over both
    processes: each rank's logits are its rows of the one-process
    forward and the new running statistics are the one-process ones
    (float64, rtol and atol 1e-12); against the JAX train forward in
    float32 at rtol 1e-4, atol 1e-5."""
    import jax
    import jax.numpy as jnp

    from dct_cryptonets_tpu.models import resnet as JRES
    from dct_cryptonets_tpu.models.topology import StemSpec as JStem
    from dct_cryptonets_tpu_torch.data.codec import dct_ingest
    inp, outs, _ = world
    logits, state = train_forward(inp["params"], inp["state"],
                                  inp["images"])
    got = np.concatenate([o["forward"][0] for o in outs])
    np.testing.assert_allclose(got, logits, rtol=1e-12, atol=1e-12)
    for o in outs:
        for g, w in zip(tree_leaves(o["forward"][1]),
                        tree_leaves(state)):
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12)
    jspec = JRES.ModelSpec(**SMALL_KW, stem_override=JStem(
        1, 1, 0, None, None, 4, True))
    x = dct_ingest(inp["images"], codec()).numpy()
    _, jlogits, jstate = JRES.forward(
        jax.tree_util.tree_map(jnp.asarray, inp["params"]),
        jax.tree_util.tree_map(jnp.asarray, inp["state"]),
        jnp.asarray(x), jspec, train=True)
    np.testing.assert_allclose(got, np.asarray(jlogits), rtol=1e-4,
                               atol=1e-5)
    for g, w in zip(jax.tree_util.tree_leaves(outs[0]["forward"][1]),
                    jax.tree_util.tree_leaves(jstate)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4,
                                   atol=1e-5)


def test_module_forward_across_processes(world):
    """``forward(fhe="execute", mesh=host_chip_mesh())`` with the batch of
    3 padded to the 4 entries of two processes: every rank decrypts the
    unsharded run's features of the padded batch (same keygen seed, same
    Csprng), bit for bit, and reports its slip counts, all-reduced."""
    from dct_cryptonets_tpu_torch.fhe.keys import Csprng
    inp, outs, _ = world
    module = inp["module"]
    module.keygen(seed=6)
    x = np.concatenate([inp["x"], inp["x"][-1:]], axis=0)
    want = module.forward(x, fhe="execute", enc_rng=Csprng(9),
                          check_ref=True)[:3]
    for feats, stats in (o["module"] for o in outs):
        np.testing.assert_array_equal(feats, want)
        for k in MODULE_STATS:
            assert stats[k] == module.stats[k], k
    assert module.stats["pbs_executed"] == 4 * module.circuit.num_pbs


def test_encrypted_batch_with_broadcast_keys(world):
    """Every rank decrypts the gathered batch to the identity table,
    and the bootstrapped ciphertexts equal the JAX package's
    unsharded bootstrap of the same ciphertexts under the same keys,
    bit for bit."""
    import jax.numpy as jnp

    from dct_cryptonets_tpu.fhe import keys as JKEYS
    from dct_cryptonets_tpu.fhe import pbs as JP
    from dct_cryptonets_tpu.fhe import torus as JT
    from dct_cryptonets_tpu.fhe.params import TEST_PARAMS as J_TEST_PARAMS
    _, outs, _ = world
    ck = JKEYS.keygen(J_TEST_PARAMS, seed=0)
    dsk = JP.preprocess_server_keys(JKEYS.make_server_keys(ck, seed=1))
    _, msgs, ct = ciphertexts()
    tables = np.tile(np.arange(2 ** BITS, dtype=np.int32), (BATCH, 1))
    want = JT.to_u64(JP.bootstrap(JT.from_u64(ct), jnp.asarray(tables),
                                  dsk, J_TEST_PARAMS,
                                  out_delta_log2=64 - BITS - 1))
    for o in outs:
        np.testing.assert_array_equal(o["decrypted"], msgs)
        np.testing.assert_array_equal(o["bootstrapped"], want)


if __name__ == "__main__":
    worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
