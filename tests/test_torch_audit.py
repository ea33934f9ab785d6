"""The port's noise audit, ``drop_policy="audit"`` and ``simulate_noisy``
against the JAX package: the same circuits give the same audit (every
report, the extraction knobs, ``max_p_error`` and the summary text); under
the audit policy, the same keygen seed and the same ``Csprng`` give the
same ciphertexts bit for bit, at the audited knobs and at forced ones."""
import dataclasses
import os

import numpy as np
import jax
import pytest
import torch

from dct_cryptonets_tpu.fhe import circuit as JC
from dct_cryptonets_tpu.fhe import compiler as JCOMP
from dct_cryptonets_tpu.fhe import noise_audit as JA
from dct_cryptonets_tpu.fhe import runtime as JR
from dct_cryptonets_tpu.fhe import torus as JT
from dct_cryptonets_tpu.fhe.keys import Csprng
from dct_cryptonets_tpu.fhe.params import TEST_PARAMS
from dct_cryptonets_tpu.models import calibrate_scales, init_model
from dct_cryptonets_tpu.models import resnet as JRES
from dct_cryptonets_tpu.models.topology import StemSpec as JStem
from dct_cryptonets_tpu_torch.checkpoint import load_ckpt
from dct_cryptonets_tpu_torch.fhe import circuit as C
from dct_cryptonets_tpu_torch.fhe import compiler as COMP
from dct_cryptonets_tpu_torch.fhe import noise_audit as A
from dct_cryptonets_tpu_torch.fhe import runtime as R
from dct_cryptonets_tpu_torch.fhe import torus as T
from dct_cryptonets_tpu_torch.fhe.circuit import (Tlu, simulate,
                                                  simulate_noisy)
from dct_cryptonets_tpu_torch.fhe.params import (default_exact_rounding,
                                                 params_for_precision)
from dct_cryptonets_tpu_torch.models import resnet as RES
from dct_cryptonets_tpu_torch.models.topology import StemSpec

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "checkpoints", "digits_flagship", "best.tar")

XQ = np.clip(np.random.default_rng(3).normal(0, 0.7, (1, 4, 4, 3)),
             -2, 2).astype(np.float32)


def tiny_net(widths, avgpool, blocks, seed):
    """A tiny QAT net (the nets of ``test_torch_runtime.py``) in both
    packages' specs, with numpy params calibrated by the JAX package."""
    kw = dict(name="tinyqat", block_counts=blocks, widths=widths,
              in_channels=3, img_size=4, num_classes=4, bit_width=3,
              quantized=True)
    jspec = JRES.ModelSpec(**kw, stem_override=JStem(1, 1, 0, None, None,
                                                     avgpool, True))
    spec = RES.ModelSpec(**kw, stem_override=StemSpec(1, 1, 0, None, None,
                                                      avgpool, True))
    params, state = init_model(jax.random.key(seed), jspec)
    x = jax.random.normal(jax.random.key(seed + 1), (8, 4, 4, 3))
    for _ in range(2):
        _, _, state = JRES.forward(params, state, x, jspec, train=True)
    params = calibrate_scales(params, state, x, jspec)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return jspec, spec, to_np(params), to_np(state)


NETS = {"one stage": ((4,), 4, (1,), 0), "two stages": ((4, 8), 2, (1, 1), 4)}


@pytest.fixture(scope="module")
def nets():
    return {name: tiny_net(*args) for name, args in NETS.items()}


def compile_both(net, method, **extra):
    jspec, spec, p, s = net
    kw = dict(n_bits=3, rounding_threshold_bits={"n_bits": 3,
                                                 "method": method},
              calib_absmax=2.0, tfhe_params=TEST_PARAMS, pbs_batch=512,
              drop_policy="audit", **extra)
    return (JR.compile_qat_model(p, s, jspec, **kw),
            R.compile_qat_model(p, s, spec, device="cpu", **kw))


def assert_same_audit(got, want):
    assert type(got).__module__.startswith("dct_cryptonets_tpu_torch")
    for f in ("p_error", "rounding_method", "aux_drop_limbs", "aux_cross",
              "aux_fwd_ks_drop", "aux_back_ks_drop"):
        assert getattr(got, f) == getattr(want, f), f
    assert dataclasses.astuple(got.params) == dataclasses.astuple(want.params)
    assert len(got.reports) == len(want.reports)
    for g, w in zip(got.reports, want.reports):
        assert dataclasses.asdict(g) == dataclasses.asdict(w)
        assert (g.cleared, g.p_total) == (w.cleared, w.p_total)
    assert list(got.by_acc) == list(want.by_acc)
    assert got.max_p_error == want.max_p_error
    assert got.summary() == want.summary()


@pytest.mark.parametrize("method", ["exact", "approximate"])
@pytest.mark.parametrize("net", list(NETS))
def test_audit_of_tiny_nets_matches_jax(nets, net, method):
    jm, tm = compile_both(nets[net], method)
    got = tm.run_audit()
    assert got is tm.run_audit()                 # cached
    assert_same_audit(got, jm.run_audit())
    assert set(got.by_acc) == {op.x for op in tm.circuit.ops
                               if isinstance(op, Tlu)}


def test_unknown_drop_policy_raises(nets):
    jspec, spec, p, s = nets["one stage"]
    with pytest.raises(ValueError, match="drop_policy"):
        R.compile_qat_model(p, s, spec, n_bits=3, rounding_threshold_bits=3,
                            calib_absmax=2.0, tfhe_params=TEST_PARAMS,
                            drop_policy="fastest", device="cpu")


@pytest.fixture(scope="module")
def flagship_circuits():
    """The flagship circuit lowered by both packages (the calibration of
    ``test_torch_compile.py``'s ``flagship`` fixture)."""
    ck = load_ckpt(CKPT)
    params, state = ck["state"]
    calib = np.clip(np.random.default_rng(0).normal(0, 1, (8, 16, 16, 24)),
                    -3, 3).astype(np.float32)
    kw = dict(n_bits=5, rounding_threshold_bits=6, calib_data=calib)
    return (COMP.lower(params, state, RES.build_spec(
                "ResNet20qat", in_channels=24, img_size=16), **kw),
            JCOMP.lower(params, state, JRES.build_spec(
                "ResNet20qat", in_channels=24, img_size=16), **kw))


@pytest.mark.parametrize("p_error", [0.01, 0.015])
def test_audit_of_flagship_matches_jax(flagship_circuits, p_error):
    circ, jcirc = flagship_circuits
    p = params_for_precision(6)
    cfg = default_exact_rounding(p)
    got = A.audit_circuit(circ, p, p_error=p_error, exact_cfg=cfg)
    assert_same_audit(got, JA.audit_circuit(jcirc, p, p_error=p_error,
                                            exact_cfg=cfg))
    assert got.max_p_error <= p_error
    assert all(0 <= r.drop_limbs <= A.MAX_DROP for r in got.reports)
    assert A.KNOB_LADDER == JA.KNOB_LADDER


def identity_circuit(r, shift, ir=C):
    """One TLU with an identity table (adjacent entries always differ), in
    the circuit classes of ``ir`` (the port's or the JAX package's)."""
    n_in = r + shift
    table = (np.arange(1 << r, dtype=np.int32) - (1 << (r - 1)))[None]
    return ir.Circuit(
        ops=[ir.QuantIn(scale=1.0, bits=n_in, n=n_in, out="x0"),
             ir.Tlu("x0", ir.TluSpec(in_bits=r, shift=shift, out_n=r), table,
                    "y"),
             ir.Output("y", scale=1.0)],
        input_shape=(1, 1, 1), n_budget={"x0": n_in, "y": r},
        meta={"shapes": {"x0": (1, 1, 1), "y": (1, 1, 1)}})


def force_knobs(m, drop, cross, keep, aux, ks_drop):
    """Set every report's knobs and the extraction knobs of module m."""
    for rep in m.run_audit().reports:
        rep.drop_limbs, rep.cross, rep.keep_low = drop, cross, keep
    m.aux_drop_limbs, m.aux_cross = aux
    m.aux_fwd_ks_drop = m.aux_back_ks_drop = ks_drop


def assert_aux_pbs_count(m):
    """One image: (shift - keep_low) extraction bootstraps per site."""
    keep = {r.acc: r.keep_low for r in m.run_audit().reports}
    assert m.stats["aux_pbs_executed"] == sum(
        max(op.spec.shift - min(keep[op.x], op.spec.shift), 0)
        * int(np.prod(m.circuit.meta["shapes"][op.x]))
        for op in m.circuit.ops if isinstance(op, Tlu))


def test_run_encrypted_at_audited_knobs_matches_jax(nets):
    jm, tm = compile_both(nets["one stage"], "exact")
    jm.keygen(seed=5)
    tm.keygen(seed=5)
    # keygen takes the extraction knobs from the audit
    ja = jm.run_audit()
    for m in (jm, tm):
        assert (m.aux_drop_limbs, m.aux_cross, m.aux_fwd_ks_drop,
                m.aux_back_ks_drop) == (ja.aux_drop_limbs, ja.aux_cross,
                                        ja.aux_fwd_ks_drop,
                                        ja.aux_back_ks_drop)
    tm.aux_batch = 48
    want = jm.run_encrypted(jm.encrypt(XQ, rng=Csprng(9)))
    got = tm.run_encrypted(tm.encrypt(XQ, rng=Csprng(9)))
    np.testing.assert_array_equal(T.to_u64(got), JT.to_u64(want))
    assert_aux_pbs_count(tm)


def test_run_encrypted_at_forced_knobs_matches_jax():
    """Every knob away from its default at once, on one TLU whose
    accumulators cover every residue of the cleared bits: main (2, 1),
    keep_low 2 of shift 3, aux (2, 1), both keyswitches truncated by 1."""
    kw = dict(pbs_batch=512, drop_policy="audit")
    jm = JR.CompiledModule(identity_circuit(4, 3, JC), TEST_PARAMS, **kw)
    tm = R.CompiledModule(identity_circuit(4, 3), TEST_PARAMS, device="cpu",
                          **kw)
    tm.aux_batch = 48
    acc = np.arange(-64, 60, dtype=np.float32).reshape(-1, 1, 1, 1)
    for m in (jm, tm):
        m.keygen(seed=5)
        force_knobs(m, 2, 1, 2, (2, 1), 1)
    want = jm.run_encrypted(jm.encrypt(acc, rng=Csprng(9)))
    got = tm.run_encrypted(tm.encrypt(acc, rng=Csprng(9)))
    np.testing.assert_array_equal(T.to_u64(got), JT.to_u64(want))
    assert tm.stats["aux_pbs_executed"] == len(acc)        # shift - keep


def test_execute_matches_simulate_audit_partial_clearing(nets):
    """keep_low 2 with every drop 0: execute == simulate.  Subtracting the
    keep_low centering constant before the clearing instead of after it
    borrows across the cleared bit field, and the main PBS then reads one
    window low on a 2^(keep-1)/2^shift fraction of accumulator values."""
    _, tm = compile_both(nets["one stage"], "exact")
    tm.keygen(seed=5)
    force_knobs(tm, 0, 0, 2, (0, 0), 0)
    xq = np.clip(np.random.default_rng(3).normal(0, 0.7, (2, 4, 4, 3)),
                 -2, 2).astype(np.float32)
    np.testing.assert_array_equal(tm.forward(xq, fhe="execute"),
                                  tm.forward(xq, fhe="simulate"))


def test_partial_clearing_centering_order():
    """Every residue mod 2^shift, many times, through keep_low 2 < shift 3:
    with an identity table every misread is an output mismatch."""
    m = R.CompiledModule(identity_circuit(4, 3), TEST_PARAMS, pbs_batch=512,
                         drop_policy="audit", device="cpu")
    m.keygen(seed=7)
    force_knobs(m, 0, 0, 2, (0, 0), 0)
    acc = np.arange(-64, 60, dtype=np.float32).reshape(-1, 1, 1, 1)
    np.testing.assert_array_equal(m.forward(acc, fhe="execute"),
                                  m.forward(acc, fhe="simulate"))
    assert m.stats["aux_pbs_executed"] == len(acc)


@pytest.mark.parametrize("net", list(NETS))
def test_simulate_noisy_without_slips_is_simulate(nets, net):
    _, tm = compile_both(nets[net], "exact")
    x = np.random.default_rng(1).normal(0, 0.7, (3, 4, 4, 3))
    g = torch.Generator().manual_seed(0)
    assert torch.equal(simulate_noisy(tm.circuit, x, g, 0.0),
                       simulate(tm.circuit, x))


def test_simulate_noisy_same_seed_same_output(nets):
    _, tm = compile_both(nets["two stages"], "exact")
    x = np.random.default_rng(2).normal(0, 0.7, (4, 4, 4, 3))
    runs = [simulate_noisy(tm.circuit, x, torch.Generator().manual_seed(s),
                           0.3) for s in (11, 11, 12)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])


@pytest.mark.parametrize("p_slip", [0.01, 0.5])
def test_simulate_noisy_slip_rate(p_slip):
    """On an identity table the output is the index: the realized slip
    fraction stays within 5 sigma of p_slip, and every slip is one step,
    up or down, before clipping (interior indices are never clipped)."""
    r = 4
    circ = identity_circuit(r, 0)
    n = 20000
    idx = np.random.default_rng(3).integers(0, 1 << r, n)
    x = (idx - (1 << (r - 1))).astype(np.float32).reshape(-1, 1, 1, 1)
    clean = simulate(circ, x).numpy().ravel()
    got = simulate_noisy(circ, x, torch.Generator().manual_seed(4),
                         p_slip).numpy().ravel()
    d = got - clean
    assert set(np.unique(d)) <= {-1.0, 0.0, 1.0}
    interior = (idx > 0) & (idx < (1 << r) - 1)
    rate = np.count_nonzero(d[interior]) / interior.sum()
    sigma = np.sqrt(p_slip * (1 - p_slip) / interior.sum())
    assert abs(rate - p_slip) <= 5 * sigma, (rate, p_slip, sigma)
    ups = np.count_nonzero(d[interior] > 0)
    n_slips = np.count_nonzero(d[interior])
    assert abs(ups - n_slips / 2) <= 5 * np.sqrt(n_slips / 4)
    # at the edges a slip outward is clipped away
    assert np.all(got[idx == 0] >= clean[idx == 0])
    assert np.all(got[idx == (1 << r) - 1] <= clean[idx == (1 << r) - 1])
