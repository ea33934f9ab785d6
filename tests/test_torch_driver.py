"""The port's eval driver and data pipeline: the CLI in simulate mode, the
seeded splits and batching against the JAX package, and the import rule
(the port never loads JAX)."""
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
          "--fhe_mode", "simulate", "--calib_batch_size", "8"])
    out = capsys.readouterr().out
    assert "Loaded checkpoint" in out
    assert "Max bit-width:" in out and "it works in FHE" in out
    assert "PBS per image: 196672" in out
    assert "ENCRYPTED test inference in SIMULATE mode" in out
    assert "Encrypted top1 acc:" in out
    assert "Done" in out


def test_unported_driver_paths_raise():
    from dct_cryptonets_tpu_torch.homomorphic_eval import main
    base = ["--dataset", "synthetic", "--dct_status", "--channels", "24",
            "--filter_size", "4", "--image_size_dct", "16"]
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


def test_port_never_imports_jax():
    """Every port module imports, and a CPU bootstrap runs on both
    engines, without JAX entering ``sys.modules``."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import numpy as np, torch
        import dct_cryptonets_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                      pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        from dct_cryptonets_tpu.fhe import keys as KEYS
        from dct_cryptonets_tpu.fhe.params import TEST_PARAMS as par
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
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "optax",
                                               "flax"))
        print(len(names), "modules;", "loaded:", loaded)
        assert not loaded, loaded
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "loaded: []" in res.stdout
