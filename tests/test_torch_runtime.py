"""The slice at small size: a TINY QAT net compiled by both packages, keys
from the same keygen seed, inputs encrypted with the same Csprng seed; the
port's ciphertexts must equal the JAX ones bit for bit, and the port's
execute must equal its simulate."""
import numpy as np
import jax
import pytest
import torch

from dct_cryptonets_tpu.fhe import runtime as JR
from dct_cryptonets_tpu.fhe import torus as JT
from dct_cryptonets_tpu.fhe.keys import Csprng
from dct_cryptonets_tpu.fhe.params import TEST_PARAMS
from dct_cryptonets_tpu.models import calibrate_scales, init_model
from dct_cryptonets_tpu.models import resnet as JRES
from dct_cryptonets_tpu.models.topology import StemSpec as JStem
from dct_cryptonets_tpu_torch.fhe import runtime as R
from dct_cryptonets_tpu_torch.fhe import torus as T
from dct_cryptonets_tpu_torch.fhe.circuit import Rescale
from dct_cryptonets_tpu_torch.models import resnet as RES
from dct_cryptonets_tpu_torch.models.topology import StemSpec

torch.set_num_threads(1)


def specs(widths, avgpool, blocks):
    kw = dict(name="tinyqat", block_counts=blocks, widths=widths,
              in_channels=3, img_size=4, num_classes=4, bit_width=3,
              quantized=True)
    return (JRES.ModelSpec(**kw, stem_override=JStem(1, 1, 0, None, None,
                                                     avgpool, True)),
            RES.ModelSpec(**kw, stem_override=StemSpec(1, 1, 0, None, None,
                                                       avgpool, True)))


def jax_params(jspec, seed):
    params, state = init_model(jax.random.key(seed), jspec)
    x = jax.random.normal(jax.random.key(seed + 1), (8, 4, 4, 3))
    for _ in range(2):
        _, _, state = JRES.forward(params, state, x, jspec, train=True)
    params = calibrate_scales(params, state, x, jspec)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return params, state, to_np(params), to_np(state)


def compile_both(jspec, spec, jp, js, p, s, method):
    kw = dict(n_bits=3, rounding_threshold_bits={"n_bits": 3,
                                                 "method": method},
              calib_absmax=2.0, tfhe_params=TEST_PARAMS, pbs_batch=512)
    return (JR.compile_qat_model(jp, js, jspec, **kw),
            R.compile_qat_model(p, s, spec, device="cpu", **kw))


XQ = np.clip(np.random.default_rng(3).normal(0, 0.7, (1, 4, 4, 3)),
             -2, 2).astype(np.float32)


@pytest.fixture(scope="module")
def tiny():
    jspec, spec = specs((4,), 4, (1,))
    return (jspec, spec) + jax_params(jspec, 0)


@pytest.fixture(scope="module")
def jax_runs(tiny):
    """JAX ciphertexts of XQ per rounding method (keygen seed 5,
    encryption Csprng(9))."""
    jspec, spec, jp, js, p, s = tiny
    out = {}
    for method in ("exact", "approximate"):
        jm, _ = compile_both(jspec, spec, jp, js, p, s, method)
        jm.keygen(seed=5)
        ct = jm.run_encrypted(jm.encrypt(XQ, rng=Csprng(9)))
        out[method] = JT.to_u64(ct)
    return out


@pytest.mark.parametrize("method,pbs_batch,aux_batch", [
    ("exact", 16, 48), ("approximate", 512, 4096)])
def test_run_encrypted_matches_jax(tiny, jax_runs, method, pbs_batch,
                                   aux_batch):
    jspec, spec, jp, js, p, s = tiny
    jm, tm = compile_both(jspec, spec, jp, js, p, s, method)
    tm.pbs_batch, tm.aux_batch = pbs_batch, aux_batch
    tm.keygen(seed=5)
    ct_in = tm.encrypt(XQ, rng=Csprng(9))
    jm.client_keys = tm.client_keys
    np.testing.assert_array_equal(
        T.to_u64(ct_in), JT.to_u64(jm.encrypt(XQ, rng=Csprng(9))))
    out = tm.run_encrypted(ct_in)
    np.testing.assert_array_equal(T.to_u64(out), jax_runs[method])
    np.testing.assert_array_equal(tm.decrypt_feats(out),
                                  tm.forward(XQ, fhe="simulate"))
    assert tm.stats["pbs_executed"] == tm.circuit.num_pbs
    assert (tm.stats.get("aux_pbs_executed", 0) > 0) == (method == "exact")
    for key in ("execute_time", "levelled_time", "pbs_time", "pbs_per_sec",
                "keygen_time"):
        assert tm.stats[key] > 0


def test_forward_execute_equals_simulate_and_slip_audit(tiny):
    jspec, spec, jp, js, p, s = tiny
    _, tm = compile_both(jspec, spec, jp, js, p, s, "exact")
    tm.keygen(seed=7)
    x = np.clip(np.random.default_rng(5).normal(0, 0.7, (1, 4, 4, 3)),
                -2, 2).astype(np.float32)
    feats = tm.forward(x, fhe="execute", check_ref=True)
    np.testing.assert_array_equal(feats, tm.forward(x, fhe="simulate"))
    assert tm.stats["tlu_slips"] == 0
    assert tm.stats["tlu_sites"] == tm.circuit.num_pbs


def test_rescale_circuit_matches_jax():
    """Two-stage net whose shortcut TLU needs a phase-only Rescale."""
    jspec, spec = specs((4, 8), 2, (1, 1))
    jp, js, p, s = jax_params(jspec, 4)
    jm, tm = compile_both(jspec, spec, jp, js, p, s, "approximate")
    assert any(isinstance(op, Rescale) for op in tm.circuit.ops)
    jm.keygen(seed=6)
    tm.keygen(seed=6)
    want = jm.run_encrypted(jm.encrypt(XQ, rng=Csprng(2)))
    got = tm.run_encrypted(tm.encrypt(XQ, rng=Csprng(2)))
    np.testing.assert_array_equal(T.to_u64(got), JT.to_u64(want))
    np.testing.assert_array_equal(tm.decrypt_feats(got),
                                  tm.forward(XQ, fhe="simulate"))
