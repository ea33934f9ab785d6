"""ResNet-18 through the port's encrypted path against the JAX package.

At narrow widths (4, 8, 12, 16), with a 1x1 stride-2 shortcut on each of
the three transition blocks, both packages lower the same numpy weights
op for op (both residual modes) and simulate them bit for bit, at the
DCT stems (``"64_6_32"``'s average pool 3 and ``"64_64_56"``'s average
pool 5, both without the stem relu) and at the 7x7/s2 + maxpool 3/s2 RGB
stem (the max expansion).  The port's execute on ``TEST_PARAMS`` equals
its simulate bit for bit.  At full width, on the JAX package's own
``init_model(jax.random.key(0))`` weights and ``bench.py``'s calibration,
the port's circuit equals the JAX one and its bootstrap counts equal
``bench.circuit_pbs_totals``.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import bench
from benchmark.rates import circuit_pbs_totals
from dct_cryptonets_tpu.data import CodecConfig, dct_ingest
from dct_cryptonets_tpu.data.pipeline import load_synthetic
from dct_cryptonets_tpu.fhe import circuit as JC
from dct_cryptonets_tpu.fhe import compiler as JCOMP
from dct_cryptonets_tpu.fhe.params import params_for_precision as jparams_for
from dct_cryptonets_tpu.models import (build_spec, calibrate_scales, forward,
                                       init_model)
from dct_cryptonets_tpu.models import resnet as JRES
from dct_cryptonets_tpu.models.topology import StemSpec as JStem
from dct_cryptonets_tpu_torch.fhe import circuit as C
from dct_cryptonets_tpu_torch.fhe import compiler as COMP
from dct_cryptonets_tpu_torch.fhe.circuit import PoolSum, Tlu
from dct_cryptonets_tpu_torch.fhe.params import TEST_PARAMS
from dct_cryptonets_tpu_torch.fhe.params import params_for_precision
from dct_cryptonets_tpu_torch.fhe.runtime import compile_qat_model
from dct_cryptonets_tpu_torch.models import resnet as RES
from dct_cryptonets_tpu_torch.models.topology import StemSpec, stem_spec

torch.set_num_threads(1)

# (in_channels, img_size, stem): the DCT stems of "64_6_32" and
# "64_64_56" (1x1 conv, no stem relu, average pool 3 / 5) and the RGB
# 7x7/s2 + maxpool 3/s2 stem, each sized so four stages end on the pool
STEMS = {
    "dct_pool3": (6, 24, (1, 1, 0, None, None, 3, False)),
    "dct_pool5": (8, 40, (1, 1, 0, None, None, 5, False)),
    "maxpool": (3, 48, (7, 2, 3, 3, 2, 2, True)),
}
NARROW = dict(block_counts=(2, 2, 2, 2), widths=(4, 8, 12, 16),
              num_classes=4, bit_width=4, quantized=True,
              skip_single_downsample=False)
# the flagship's quantization (bit_width 4, n_bits 5, rounding 6)
LOWER_KW = dict(n_bits=5, rounding_threshold_bits=6)
# execute: the RGB stem on 24^2 (12^2 after the stem conv, 6^2 after the
# maxpool, 1^2 after the fourth stage), widths (2, 4, 6, 8), 4-bit TLUs
# under exact rounding, calibrated on 4 images.  At 3-bit rounding, or on
# other draws of this size, the calibration bounds do not settle in either
# package (compiler.lower raises)
EXEC = dict(in_channels=3, img_size=24, widths=(2, 4, 6, 8), bit_width=3,
            stem=(7, 2, 3, 3, 2, 1, True))
EXEC_KW = dict(n_bits=3, rounding_threshold_bits=4)


def narrow_specs(stem):
    in_ch, img, st = STEMS[stem]
    kw = dict(name="resnet18qat", in_channels=in_ch, img_size=img, **NARROW)
    return (JRES.ModelSpec(**kw, stem_override=JStem(*st)),
            RES.ModelSpec(**kw, stem_override=StemSpec(*st)))


def jax_prep(jspec, seed=0, B=4):
    """JAX weights with BN statistics and calibrated scales (the JAX
    package's own compiler tests' recipe), and numpy copies of all."""
    params, state = init_model(jax.random.key(seed), jspec)
    x = jax.random.normal(jax.random.key(seed + 1),
                          (B, jspec.img_size, jspec.img_size,
                           jspec.in_channels))
    _, _, state = forward(params, state, x, jspec, train=True)
    params = calibrate_scales(params, state, x, jspec)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return params, state, to_np(params), to_np(state), np.asarray(x)


def assert_same_circuit(got, want):
    assert len(got.ops) == len(want.ops)
    for g, w in zip(got.ops, want.ops):
        assert type(g).__name__ == type(w).__name__
        for f in dataclasses.fields(w):
            a, b = getattr(g, f.name), getattr(w, f.name)
            if isinstance(b, np.ndarray):
                np.testing.assert_array_equal(a, b)
            elif dataclasses.is_dataclass(b):
                assert dataclasses.astuple(a) == dataclasses.astuple(b)
            else:
                assert a == b, (type(w).__name__, f.name, a, b)
    assert got.n_budget == want.n_budget
    assert got.input_shape == want.input_shape
    assert got.num_pbs == want.num_pbs
    assert got.dump() == want.dump()


@pytest.fixture(scope="module", params=list(STEMS))
def narrow(request):
    jspec, spec = narrow_specs(request.param)
    return (request.param, jspec, spec) + jax_prep(jspec)


def test_narrow_specs_cover_the_resnet18_paths(narrow):
    stem, jspec, spec = narrow[:3]
    layout = list(spec.block_layout())
    assert layout == list(jspec.block_layout())
    # a 1x1 stride-2 shortcut on each of the three transition blocks
    assert [(i, o) for i, o, half in layout if half] == [(4, 8), (8, 12),
                                                         (12, 16)]
    assert all(i != o for i, o, half in layout if half)
    assert RES.trunk_feat_dim(spec) == JRES.trunk_feat_dim(jspec) == 16
    if stem != "maxpool":
        assert spec.stem.relu1 is False


@pytest.mark.parametrize("mode", ["fused", "requant"])
def test_narrow_lower_and_simulate_match_jax(narrow, mode):
    stem, jspec, spec, jp, js, p, s, x = narrow
    want = JCOMP.lower(jp, js, jspec, calib_data=x, residual_mode=mode,
                       **LOWER_KW)
    got = COMP.lower(p, s, spec, calib_data=x, residual_mode=mode,
                     **LOWER_KW)
    assert_same_circuit(got, want)
    assert got.verify_encodings() == want.verify_encodings() == []
    pools = [op.k for op in got.ops if isinstance(op, PoolSum)]
    assert pools[-1] == spec.stem.avgpool_kernel
    sim, env = C.simulate(got, x, return_env=True)
    jsim, jenv = JC.simulate(want, jnp.asarray(x), return_env=True)
    np.testing.assert_array_equal(sim.numpy(), np.asarray(jsim))
    assert env.keys() == jenv.keys()
    for name in jenv:
        np.testing.assert_array_equal(env[name].numpy(),
                                      np.asarray(jenv[name]))


def test_narrow_execute_equals_simulate():
    """ResNet-18's levelled ops (the stride-2 first conv and 1x1 shortcut
    of each transition block, the average pool, the max expansion's
    AddScaled pairs) and every TLU layer, encrypted on ``TEST_PARAMS``
    under exact rounding, decrypt to the port's simulate bit for bit."""
    cfg = dict(EXEC)
    st = cfg.pop("stem")
    kw = dict(name="resnet18qat", block_counts=(2, 2, 2, 2), num_classes=4,
              quantized=True, skip_single_downsample=False, **cfg)
    jspec = JRES.ModelSpec(**kw, stem_override=JStem(*st))
    spec = RES.ModelSpec(**kw, stem_override=StemSpec(*st))
    _, _, p, s, x = jax_prep(jspec)
    m = compile_qat_model(p, s, spec, **EXEC_KW, calib_data=x,
                          tfhe_params=TEST_PARAMS, pbs_batch=4096,
                          device="cpu")
    assert sum(isinstance(op, Tlu) for op in m.circuit.ops) == 27
    m.keygen(seed=9)
    exe = m.forward(x[:1], fhe="execute", check_ref=True)
    np.testing.assert_array_equal(exe, m.forward(x[:1], fhe="simulate"))
    assert m.stats["tlu_slips"] == 0
    assert m.stats["pbs_executed"] == m.circuit.num_pbs == m.stats[
        "tlu_sites"]
    assert m.stats["aux_pbs_executed"] > 0


def bench_cifar_weights():
    """``bench.build_circuits("ResNet18qat")``'s draw and calibration:
    JAX ``init_model(jax.random.key(0))``, 64 synthetic images through the
    fs-8 codec at 6 ch x 32^2, scales then BN statistics."""
    cfg = CodecConfig(channels=6, filter_size=8, image_size_dct=32)
    jspec = build_spec("ResNet18qat", in_channels=6, img_size=32,
                       num_classes=10, bit_width=4)
    params, state = init_model(jax.random.key(0), jspec)
    ds = load_synthetic(64, cfg.pixel_size, 10, seed=0)
    x = dct_ingest(jnp.asarray(ds.images), cfg)
    params = calibrate_scales(params, state, x, jspec)
    _, _, state = forward(params, state, x, jspec, train=True)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return jspec, params, state, to_np(params), to_np(state), np.asarray(x)


def test_full_width_cifar_counts_match_bench():
    """ResNet18qat at bench.py's CIFAR preset (fused, rounding 6,
    range_margin 1.0) on the JAX package's weights: the same circuit in
    both packages, 557,568 main PBS over 18 TLUs of at most 6 bits
    (preset 6), the same extraction count."""
    jspec, jp, js, p, s, x = bench_cifar_weights()
    kw = dict(rounding_threshold_bits=6, calib_data=x, range_margin=1.0,
              residual_mode="fused")
    want = JCOMP.lower(jp, js, jspec, **kw)
    spec = RES.build_spec("ResNet18qat", in_channels=6, img_size=32,
                          num_classes=10, bit_width=4)
    assert spec.stem == stem_spec(64, 6, 32)
    got = COMP.lower(p, s, spec, **kw)
    assert_same_circuit(got, want)
    assert circuit_pbs_totals(got) == bench.circuit_pbs_totals(want)
    by_knob, _ = circuit_pbs_totals(got)
    assert by_knob == {(0, 0): 557_568}
    tlus = [op for op in got.ops if isinstance(op, Tlu)]
    max_r = max(op.spec.in_bits for op in tlus)
    assert (len(tlus), max_r) == (18, 6)
    assert dataclasses.astuple(params_for_precision(max_r)) == \
        dataclasses.astuple(jparams_for(max_r))
    assert params_for_precision(max_r).poly_size == 2048
