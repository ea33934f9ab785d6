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


def test_unported_driver_paths_raise():
    from dct_cryptonets_tpu_torch.homomorphic_eval import main
    base = ["--dataset", "synthetic", "--dct_status", "--channels", "24",
            "--filter_size", "4", "--image_size_dct", "16", "--device", "cpu"]
    with pytest.raises(NotImplementedError, match="PTQ"):
        main(base + ["--model", "ResNet20", "--checkpoint_path", CKPT])
    with pytest.raises(NotImplementedError, match="checkpoint_path"):
        main(base + ["--model", "ResNet20qat"])
    with pytest.raises(NotImplementedError, match="not yet ported"):
        PIPE.get_dataset("cifar10", None, False)


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
    """Every port module imports, and a CPU bootstrap runs on both engines
    under the port's own keys, without JAX or any ``dct_cryptonets_tpu``
    module entering ``sys.modules``."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import numpy as np, torch
        import dct_cryptonets_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                      pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
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
