"""The port's own copies of the JAX package's numpy modules (``fhe.keys``,
``fhe.params``, ``config``, ``utils`` and the DCT tables) against the
originals, bit for bit and field for field, and the port's explicit device:
without CUDA it raises unless the caller asks for the CPU."""
import dataclasses
import filecmp
import os

import numpy as np
import pytest
import torch

from dct_cryptonets_tpu import config as JCONFIG
from dct_cryptonets_tpu import utils as JUTILS
from dct_cryptonets_tpu.data import tables as JTABLES
from dct_cryptonets_tpu.fhe import keys as JKEYS
from dct_cryptonets_tpu.fhe import params as JPARAMS
from dct_cryptonets_tpu_torch import config as CONFIG
from dct_cryptonets_tpu_torch import utils as UTILS
from dct_cryptonets_tpu_torch.data import tables as TABLES
from dct_cryptonets_tpu_torch.fhe import keys as KEYS
from dct_cryptonets_tpu_torch.fhe import params as PARAMS
from dct_cryptonets_tpu_torch.fhe import runtime as R

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "checkpoints", "digits_flagship", "best.tar")


def fields(p):
    return dataclasses.asdict(p)


def assert_same_arrays(got, want):
    assert sorted(vars(got)) == sorted(vars(want))
    for name, w in vars(want).items():
        g = getattr(got, name)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g, w, err_msg=name)
        elif dataclasses.is_dataclass(w):
            assert fields(g) == fields(w), name
        else:
            assert g == w, name


@pytest.mark.parametrize("name", ["TEST_PARAMS", "TEST_PARAMS_K2"])
def test_keys_match_jax(name):
    """keygen, server keys, aux server keys, encrypt and decrypt from the
    same seeds give the same arrays in both packages."""
    par, jpar = getattr(PARAMS, name), getattr(JPARAMS, name)
    ck, jck = KEYS.keygen(par, seed=3), JKEYS.keygen(jpar, seed=3)
    assert_same_arrays(ck, jck)
    assert_same_arrays(KEYS.make_server_keys(ck, seed=4),
                       JKEYS.make_server_keys(jck, seed=4))
    aux = PARAMS.default_exact_rounding(par).aux
    assert_same_arrays(
        KEYS.make_aux_server_keys(ck, aux, seed=5, back_base_log=4,
                                  back_levels=6),
        JKEYS.make_aux_server_keys(jck, JPARAMS.default_exact_rounding(
            jpar).aux, seed=5, back_base_log=4, back_levels=6))
    mu = np.random.default_rng(6).integers(0, 2 ** 63, (3, 5)).astype(
        np.uint64)
    for key in (None, ck.big_lwe_key):
        ct = KEYS.encrypt_lwe(ck, mu, KEYS.Csprng(7), key=key)
        jct = JKEYS.encrypt_lwe(jck, mu, JKEYS.Csprng(7), key=key)
        np.testing.assert_array_equal(ct, jct)
        np.testing.assert_array_equal(KEYS.decrypt_lwe(ck, ct, key=key),
                                      JKEYS.decrypt_lwe(jck, jct, key=key))
    np.testing.assert_array_equal(KEYS.Csprng(b"seed").normal(0, 1, 9),
                                  JKEYS.Csprng(b"seed").normal(0, 1, 9))


def test_params_match_jax():
    """Every preset, the test sets, params_for_precision and
    default_exact_rounding equal their JAX twins field for field."""
    assert PARAMS._PRESETS.keys() == JPARAMS._PRESETS.keys()
    assert PARAMS.EXTRACT_PRESETS.keys() == JPARAMS.EXTRACT_PRESETS.keys()
    assert PARAMS.DEFAULT_EXTRACT == JPARAMS.DEFAULT_EXTRACT
    sets = ([(PARAMS._PRESETS[b], JPARAMS._PRESETS[b])
             for b in JPARAMS._PRESETS]
            + [(PARAMS.EXTRACT_PRESETS[k], JPARAMS.EXTRACT_PRESETS[k])
               for k in JPARAMS.EXTRACT_PRESETS]
            + [(PARAMS.TEST_PARAMS, JPARAMS.TEST_PARAMS),
               (PARAMS.TEST_PARAMS_K2, JPARAMS.TEST_PARAMS_K2)])
    for p, jp in sets:
        assert fields(p) == fields(jp)
        assert (p.big_lwe_dim, p.delta_log2) == (jp.big_lwe_dim,
                                                 jp.delta_log2)
        nm, jnm = PARAMS.NoiseModel(p), JPARAMS.NoiseModel(jp)
        assert nm.var_blind_rotate() == jnm.var_blind_rotate()
        assert (nm.pbs_error_probability(5, nm.var_fresh_glwe())
                == jnm.pbs_error_probability(5, jnm.var_fresh_glwe()))
    for bits in range(1, 9):
        assert fields(PARAMS.params_for_precision(bits)) == fields(
            JPARAMS.params_for_precision(bits))
    with pytest.raises(ValueError, match="no parameter set"):
        PARAMS.params_for_precision(9)
    for p, jp in sets[:5] + sets[-2:]:
        assert fields(PARAMS.default_exact_rounding(p)) == fields(
            JPARAMS.default_exact_rounding(jp))
    # the flagship: preset 6 with the k2n512f extraction set
    cfg = PARAMS.default_exact_rounding(PARAMS.params_for_precision(6))
    assert fields(cfg.aux) == fields(PARAMS.EXTRACT_PRESETS["k2n512f"])


def test_tables_match_jax():
    for name in ("subset_channels.json", "dct_stats.json"):
        assert filecmp.cmp(os.path.join(TABLES._TABLE_DIR, name),
                           os.path.join(JTABLES._TABLE_DIR, name),
                           shallow=False)
    assert os.path.dirname(TABLES._TABLE_DIR) == os.path.dirname(
        os.path.abspath(TABLES.__file__))
    for ch, pat, fs in ((24, "default", 4), (64, "square", 8),
                        (48, "triangle", 8), (192, "default", 8)):
        assert TABLES.subset_indices(ch, pat, fs) == JTABLES.subset_indices(
            ch, pat, fs)
        for got, want in zip(TABLES.normalization_stats(ch, pat),
                             JTABLES.normalization_stats(ch, pat)):
            np.testing.assert_array_equal(got, want)


def test_config_and_meters_match_jax():
    argv = ["--dataset", "synthetic", "--dct_status", "--channels", "24",
            "--pbs_batch", "512"]
    got = vars(CONFIG.parse_args("homomorphic_eval", argv))
    assert got.pop("device") == "cuda"
    assert got == vars(JCONFIG.parse_args("homomorphic_eval", argv))
    assert CONFIG.parse_args("homomorphic_eval",
                             argv + ["--device", "cpu"]).device == "cpu"
    logits = np.random.default_rng(1).normal(size=(16, 10))
    targets = np.arange(16) % 10
    assert UTILS.topk_accuracy(logits, targets) == JUTILS.topk_accuracy(
        logits, targets)
    m, jm = UTILS.AverageMeter(), JUTILS.AverageMeter()
    for v, n in ((50.0, 3), (25.0, 1)):
        m.update(v, n)
        jm.update(v, n)
    assert (m.avg, m.last) == (jm.avg, jm.last)


def test_no_cuda_raises_unless_the_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        R.default_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        R.CompiledModule(None, PARAMS.TEST_PARAMS)
    assert R.CompiledModule(None, PARAMS.TEST_PARAMS,
                            device="cpu").device.type == "cpu"
    from dct_cryptonets_tpu_torch.homomorphic_eval import main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--dataset", "synthetic", "--dct_status", "--model",
              "ResNet20qat", "--channels", "24", "--filter_size", "4",
              "--image_size_dct", "16", "--checkpoint_path", CKPT])
