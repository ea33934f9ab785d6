"""The port's eval driver and data pipeline: the CLI in simulate mode, the
seeded splits and batching against the JAX package, and the import rule
(neither the port nor ``chip_smoke.py`` loads JAX or any module of the JAX
package)."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from dct_cryptonets_tpu.data import pipeline as JPIPE
from dct_cryptonets_tpu_torch.data import pipeline as PIPE

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "checkpoints", "digits_flagship", "best.tar")


def test_homomorphic_eval_simulate(capsys):
    from dct_cryptonets_tpu_torch.homomorphic_eval import main
    main(["--dataset", "synthetic", "--dct_status", "--model", "ResNet20qat",
          "--channels", "24", "--filter_size", "4", "--image_size_dct", "16",
          "--checkpoint_path", CKPT, "--test_subset", "4",
          "--fhe_mode", "simulate", "--calib_batch_size", "8",
          "--device", "cpu"])
    out = capsys.readouterr().out
    assert "Loaded checkpoint" in out
    assert "Max bit-width:" in out and "it works in FHE" in out
    assert "PBS per image: 196672" in out
    assert "ENCRYPTED test inference in SIMULATE mode" in out
    assert "Encrypted top1 acc:" in out
    assert "Done" in out


def test_dump_circuit_holds_the_audit_summary(tmp_path, capsys):
    """Under --drop_policy audit the dump is the circuit listing and the
    noise audit's summary, both equal to the JAX package's for the same
    calibration batch."""
    from dct_cryptonets_tpu.fhe import compiler as JCOMP
    from dct_cryptonets_tpu.fhe.noise_audit import audit_circuit
    from dct_cryptonets_tpu.fhe.params import (default_exact_rounding,
                                               params_for_precision)
    from dct_cryptonets_tpu.models import resnet as JRES
    from dct_cryptonets_tpu_torch.checkpoint import load_ckpt
    from dct_cryptonets_tpu_torch.data.codec import CodecConfig
    from dct_cryptonets_tpu_torch.homomorphic_eval import main, make_ingest

    dump = tmp_path / "circuit.txt"
    main(["--dataset", "synthetic", "--dct_status", "--model", "ResNet20qat",
          "--channels", "24", "--filter_size", "4", "--image_size_dct", "16",
          "--checkpoint_path", CKPT, "--test_subset", "1",
          "--fhe_mode", "simulate", "--calib_batch_size", "8",
          "--drop_policy", "audit", "--dump_circuit", str(dump),
          "--device", "cpu"])
    assert "Circuit dumped to" in capsys.readouterr().out
    listing, summary = dump.read_text().rstrip("\n").split("\n\n")

    cfg = CodecConfig(24, 4, 16)
    trainset = PIPE.get_dataset("synthetic", None, True,
                                image_size=cfg.pixel_size, num_classes=10)
    calib = make_ingest(cfg, "cpu")(trainset.gather(np.arange(8))[0])
    params, state = load_ckpt(CKPT)["state"]
    circ = JCOMP.lower(params, state,
                       JRES.build_spec("ResNet20qat", in_channels=24,
                                       img_size=16, bit_width=4),
                       n_bits=5, rounding_threshold_bits=6,
                       calib_data=calib.numpy())
    p = params_for_precision(6)
    want = audit_circuit(circ, p, p_error=0.01, rounding_method="exact",
                         exact_cfg=default_exact_rounding(p))
    assert listing == circ.dump()
    assert summary == want.summary()


def _encrypted_features(monkeypatch):
    """Record the features of every ``forward(fhe="execute")`` call."""
    from dct_cryptonets_tpu_torch.fhe.runtime import CompiledModule
    seen, forward = [], CompiledModule.forward

    def spy(self, x, fhe="simulate", **kw):
        out = forward(self, x, fhe=fhe, **kw)
        if fhe == "execute":
            seen.append(out)
        return out
    monkeypatch.setattr(CompiledModule, "forward", spy)
    return seen


def test_eval_cli_mesh_simulate_equals_unsharded(capfd):
    """``--mesh 2 --device cpu`` in simulate mode (no keys, nothing to
    shard) prints what the run without it prints, times apart."""
    from dct_cryptonets_tpu_torch.homomorphic_eval import main

    def untimed(out):
        return [ln.split("Time")[0] for ln in out.splitlines()]
    args = TINY_EVAL + ["--model", "ResNet20qat"]
    main(args)
    want = untimed(capfd.readouterr().out)
    main(args + ["--mesh", "2"])
    got = untimed(capfd.readouterr().out)
    assert "Encrypted top1 acc:" in "\n".join(got) and got == want


def test_eval_cli_mesh_execute_equals_unsharded(monkeypatch, capfd):
    """``--mesh 2 --device cpu`` in execute mode shards each batch of 3
    (padded to 4) over two CPU entries after keygen: its decrypted
    features and accuracies equal the run without ``--mesh``.  The net is
    one block on the 24-channel 4 x 4 DCT input, compiled for
    ``TEST_PARAMS`` (the presets take minutes per image on the CPU)."""
    import functools

    from dct_cryptonets_tpu_torch import homomorphic_eval as HE
    from dct_cryptonets_tpu_torch.fhe.params import TEST_PARAMS
    from dct_cryptonets_tpu_torch.models import resnet as RES
    from dct_cryptonets_tpu_torch.models.topology import StemSpec

    spec = RES.ModelSpec("tinyqat", (1,), (4,), 24, 4, bit_width=3,
                         stem_override=StemSpec(1, 1, 0, None, None, 4,
                                                True))
    monkeypatch.setattr(HE, "build_spec", lambda *a, **kw: spec)
    monkeypatch.setattr(HE, "compile_qat_model", functools.partial(
        HE.compile_qat_model, tfhe_params=TEST_PARAMS))
    feats = _encrypted_features(monkeypatch)
    args = ["--dataset", "synthetic", "--dct_status", "--model",
            "ResNet20qat", "--channels", "24", "--filter_size", "4",
            "--image_size_dct", "4", "--bit_width", "3", "--n_bits", "3",
            "--rounding_threshold_bits", "3", "--test_subset", "3",
            "--test_batch_size", "3", "--calib_batch_size", "8",
            "--fhe_mode", "execute", "--device", "cpu"]
    HE.main(args)
    want = capfd.readouterr().out
    HE.main(args + ["--mesh", "2"])
    got = capfd.readouterr().out
    assert "Sharded encrypted eval over 2 device(s)" in got
    assert len(feats) == 2 and feats[0].shape == feats[1].shape == (3, 4)
    np.testing.assert_array_equal(feats[1], feats[0])

    def lines(out):
        return [ln.split("| Time")[0] for ln in out.splitlines()
                if "Top-1 Acc" in ln]
    assert lines(got) == lines(want) and len(lines(got)) == 3


def test_train_cli_mesh_writes_a_checkpoint_jax_reads(tmp_path, capfd):
    """``train --mesh 2 --device cpu``: one short epoch over two gloo
    processes prints the mesh line and writes checkpoints that the JAX
    package's ``load_ckpt`` reads (the weights lower to a circuit)."""
    from dct_cryptonets_tpu import train as JTRAIN
    from dct_cryptonets_tpu.fhe import compiler as JCOMP
    from dct_cryptonets_tpu.models import resnet as JRES
    from dct_cryptonets_tpu_torch import train

    res = train.main(["--dataset", "synthetic", "--synthetic_size", "96",
                      "--dct_status", "--model", "ResNet20qat",
                      "--channels", "24", "--filter_size", "4",
                      "--image_size_dct", "8", "--batch_size", "16",
                      "--stop_epoch", "1", "--train_aug", "--device", "cpu",
                      "--mesh", "2", "--checkpoint_dir", str(tmp_path)])
    out = capfd.readouterr().out
    assert "Mesh: 2 device(s)" in out and "backend gloo" in out
    assert out.count("Epoch: [1 | 1]") == 1 and "Done" in out
    assert res["epochs"] == 1 and res["steps"] == 5
    ck = JTRAIN.load_ckpt(os.path.join(res["ckpt_dir"], "best.tar"))
    params, state = ck["state"]
    spec = JRES.build_spec("ResNet20qat", in_channels=24, img_size=8)
    assert JCOMP.lower(params, state, spec).num_pbs > 0


TINY_EVAL = ["--dataset", "synthetic", "--dct_status", "--channels", "24",
             "--filter_size", "4", "--image_size_dct", "8",
             "--test_subset", "2", "--calib_batch_size", "8",
             "--fhe_mode", "simulate", "--device", "cpu"]


def test_random_init_path_matches_jax():
    """Without a checkpoint the eval CLI draws a model, calibrates its
    scales and runs one train-mode forward for its BatchNorm statistics:
    the port's helper fed the JAX package's init gives the JAX CLI's
    params and state (batch statistics reduced in another order: rtol
    1e-5, atol 1e-6), and the same circuit in both packages."""
    import jax
    import jax.numpy as jnp
    from dct_cryptonets_tpu.fhe import compiler as JCOMP
    from dct_cryptonets_tpu.models import resnet as JRES
    from dct_cryptonets_tpu_torch.data.codec import CodecConfig
    from dct_cryptonets_tpu_torch.fhe import compiler as COMP
    from dct_cryptonets_tpu_torch.homomorphic_eval import (
        calibrate_random_init, make_ingest)
    from dct_cryptonets_tpu_torch.models import resnet as RES

    kw = dict(in_channels=24, img_size=8)
    spec, jspec = (RES.build_spec("ResNet20qat", **kw),
                   JRES.build_spec("ResNet20qat", **kw))
    cfg = CodecConfig(24, 4, 8)
    ds = PIPE.get_dataset("synthetic", None, True, image_size=32)
    x = make_ingest(cfg, "cpu")(ds.gather(np.arange(8))[0])
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    params, state = to_np(JRES.init_model(jax.random.key(0), jspec))
    jx = jnp.asarray(x.numpy())
    wp = JRES.calibrate_scales(params, state, jx, jspec)
    _, _, ws = JRES.forward(wp, state, jx, jspec, train=True)
    gp, gs = calibrate_random_init(params, state, x, spec)
    for g, w in zip(jax.tree_util.tree_leaves((gp, gs)),
                    jax.tree_util.tree_leaves(to_np((wp, ws)))):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    calib = x.numpy()[:4]
    assert (COMP.lower(gp, gs, spec, calib_data=calib).dump()
            == JCOMP.lower(gp, gs, jspec, calib_data=calib).dump())


def test_ptq_path_runs_and_matches_jax(capsys):
    """A float model (no 'qat' in its name) compiles by post-training
    quantization: the eval CLI runs end to end in simulate mode.  Its
    quantized params equal the JAX ``quantize_float_model``'s on the same
    float params and calibration batch (scales are maxima of float32
    activations: rtol 1e-5), and its circuit equals the JAX compile of
    those params: a scale an ulp away prints otherwise in the listing, so
    that stage is fed the port's own params."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from dct_cryptonets_tpu.fhe import runtime as JRUN
    from dct_cryptonets_tpu.models import resnet as JRES
    from dct_cryptonets_tpu_torch.config import parse_args
    from dct_cryptonets_tpu_torch.homomorphic_eval import main, prepare
    from dct_cryptonets_tpu_torch.models import resnet as RES

    main(TINY_EVAL + ["--model", "ResNet20"])
    out = capsys.readouterr().out
    assert "WARNING: No checkpoint loaded" in out
    assert "Compiling FHE Model (PTQ)" in out and "it works in FHE" in out
    assert "Encrypted top1 acc:" in out and "Done" in out
    s = prepare(parse_args("homomorphic_eval",
                           TINY_EVAL + ["--model", "ResNet20"]))
    calib = s.ingest(s.trainset.gather(np.arange(8))[0])
    jspec = JRES.build_spec("ResNet20", in_channels=24, img_size=8)
    gp, gspec = RES.quantize_float_model(s.params, s.state, calib, s.spec)
    wp, wspec = JRES.quantize_float_model(s.params, s.state,
                                          jnp.asarray(calib.numpy()), jspec)
    assert dataclasses.asdict(gspec) == dataclasses.asdict(wspec)
    for g, w in zip(jax.tree_util.tree_leaves(gp),
                    jax.tree_util.tree_leaves(wp)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5)
    want = JRUN.compile_qat_model(gp, s.state, wspec, n_bits=5,
                                  rounding_threshold_bits=6,
                                  calib_data=calib.numpy())
    assert s.module.circuit.dump() == want.circuit.dump()


def test_train_needs_a_gpu_unless_the_cpu_is_asked_for(monkeypatch):
    """Without a GPU the trainer raises unless ``--device cpu`` is given,
    as the eval CLI does."""
    from dct_cryptonets_tpu_torch import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--dataset", "synthetic", "--dct_status",
                    "--model", "ResNet20qat", "--channels", "24",
                    "--filter_size", "4", "--image_size_dct", "8"])


@pytest.mark.parametrize("n,test_size,seed", [
    (2048, 16, 42), (512, 1, 42), (512, 511, 28), (1797, 0.2, 42),
    (100, 0.33, 7)])
def test_train_val_split_matches_jax(n, test_size, seed):
    want = JPIPE.train_val_split(n, test_size, random_state=seed)
    got = PIPE.train_val_split(n, test_size, random_state=seed)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("shuffle,drop", [(False, False), (True, True)])
def test_batches_match_jax(shuffle, drop):
    ds, jds = PIPE.load_synthetic(37, 16, seed=3), JPIPE.load_synthetic(
        37, 16, seed=3)
    idx = np.arange(3, 37)
    got = list(PIPE.batches(ds, idx, 8, shuffle=shuffle, seed=2,
                            drop_remainder=drop))
    want = list(JPIPE.batches(jds, idx, 8, shuffle=shuffle, seed=2,
                              drop_remainder=drop))
    assert len(got) == len(want)
    for (gi, gl), (wi, wl) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)


# modules that must never load in the port's process: JAX and its kin, and
# the JAX package itself (even its numpy-only modules)
FORBIDDEN = ("jax", "jaxlib", "optax", "flax", "dct_cryptonets_tpu")
LOADED = (f"loaded = sorted(m for m in sys.modules "
          f"if m.split('.')[0] in {FORBIDDEN!r})")


def run_isolated(code: str) -> str:
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    return res.stdout


def test_port_never_imports_jax():
    """Every port module, its tools (``dct_cryptonets_tpu_torch/tools/``)
    and the benchmark's scripts (``benchmark/run.py``,
    ``benchmark/rates.py``) import, a train step runs on the CPU
    (``dct_cryptonets_tpu_torch.train``), a CPU bootstrap runs on both
    engines under the port's own keys, and a sharded one and the sharded
    ingest run on a CPU mesh (``dct_cryptonets_tpu_torch.parallel``),
    without JAX or any ``dct_cryptonets_tpu`` module entering
    ``sys.modules``."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import numpy as np, torch
        import dct_cryptonets_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                      pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        import benchmark.rates, benchmark.run
        import glob, importlib.util
        for path in sorted(glob.glob("dct_cryptonets_tpu_torch/tools/*.py")):
            spec = importlib.util.spec_from_file_location(
                "tool_" + path.split("/")[-1][:-3], path)
            spec.loader.exec_module(importlib.util.module_from_spec(spec))
        import dct_cryptonets_tpu_torch.train as TRAIN
        from dct_cryptonets_tpu_torch.models import resnet as RES
        from dct_cryptonets_tpu_torch.models.topology import StemSpec
        spec = RES.ModelSpec("t", (1,), (4,), 3, 4, num_classes=4,
                             bit_width=3, stem_override=StemSpec(
                                 1, 1, 0, None, None, 4, True))
        model = RES.QATResNet.from_params(*RES.init_model(spec), spec)
        cfg = TRAIN.parse_args("train", ["--device", "cpu"])
        opt = TRAIN.make_optimizer(cfg, 1e-3, model.parameters())
        x = torch.randn((8, 4, 4, 3), generator=torch.Generator().manual_seed(0))
        loss, _ = TRAIN.train_step(model, opt, cfg, x, torch.arange(8) % 4,
                                   torch.Generator())
        assert np.isfinite(float(loss))
        from dct_cryptonets_tpu_torch.fhe import keys as KEYS
        from dct_cryptonets_tpu_torch.fhe.params import TEST_PARAMS as par
        from dct_cryptonets_tpu_torch.fhe import pbs as P, torus as T
        ck = KEYS.keygen(par, seed=1)
        dsk = P.preprocess_server_keys(KEYS.make_server_keys(ck, seed=2))
        msgs = np.arange(4) % 8
        ct = KEYS.encrypt_lwe(ck, msgs.astype(np.uint64) << np.uint64(60),
                              np.random.default_rng(0), key=ck.big_lwe_key,
                              noise_log2=par.glwe_noise_log2)
        tables = torch.arange(8, dtype=torch.int32).repeat(4, 1)
        for engine in ("plain", "s2d_plain"):
            out = P.bootstrap(T.from_u64(ct), tables, dsk, par, 58,
                              engine=engine)
            phase = KEYS.decrypt_lwe(ck, T.to_u64(out), key=ck.big_lwe_key)
            dec = np.round(phase.astype(np.int64) / 2.0 ** 58).astype(int)
            assert (dec == msgs).all(), (engine, dec)
        from dct_cryptonets_tpu_torch.data import (CodecConfig, dct_ingest,
                                                   dct_ingest_sharded)
        from dct_cryptonets_tpu_torch.parallel import (data_mesh, replicate,
                                                       shard_batch)
        from dct_cryptonets_tpu_torch.parallel.mesh import run_sharded
        mesh = data_mesh(2, devices="cpu")
        ct_s, tab_s = shard_batch(mesh, (T.from_u64(ct), tables))
        got = run_sharded(mesh, lambda c, t, k: P.bootstrap(c, t, k, par, 58),
                          ct_s, tab_s, replicate(mesh, dsk)).gather()
        assert torch.equal(got, out)
        imgs = np.zeros((1, 32, 32, 3), np.uint8)
        assert torch.equal(dct_ingest_sharded(imgs, CodecConfig(24, 4, 8),
                                              mesh),
                           dct_ingest(imgs, CodecConfig(24, 4, 8)))
    """) + LOADED + """
print(len(names), "modules;", "loaded:", loaded)
"""
    assert "loaded: []" in run_isolated(code)


def test_chip_smoke_never_imports_jax():
    """``chip_smoke`` imports without JAX or the JAX package."""
    out = run_isolated("import sys\nimport chip_smoke\n" + LOADED
                       + "\nprint('loaded:', loaded)\n")
    assert "loaded: []" in out


def test_chip_smoke_refuses_to_run_without_a_gpu():
    """Without a usable GPU the smoke exits nonzero and prints no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "chip_smoke.py"],
                         capture_output=True, text=True, cwd=REPO, env=env,
                         timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout and "kernels" not in res.stdout
