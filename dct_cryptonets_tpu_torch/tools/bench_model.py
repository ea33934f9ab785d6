#!/usr/bin/env python3
"""PBS rates of a model's encrypted circuit on one GPU, priced into an
image: the port's counterpart of the root ``bench.py``, with its four
environment knobs, its printed lines and its JSON last line.

    python3 dct_cryptonets_tpu_torch/tools/bench_model.py
    BENCH_MODEL=ResNet18qat python3 \
        dct_cryptonets_tpu_torch/tools/bench_model.py
    BENCH_PRESET=7 python3 dct_cryptonets_tpu_torch/tools/bench_model.py

Knobs (``bench.py``'s names and defaults):
  BENCH_M       main bootstrap batch (default 2048, ``bench.py``'s on an
                accelerator); the extraction batch is twice it
  BENCH_MODE    ``exact`` (default: also times the extraction lattice) or
                ``approximate`` (no extraction rate)
  BENCH_MODEL   ``ResNet20qat`` (default; DCT 24 ch / filter 4 / 16^2, the
                reference's 565 s row, README.md:84) or ``ResNet18qat``
                (6 ch / filter 8 / 32^2, the 1,004 s row, README.md:88)
  BENCH_PRESET  the main lattice's preset by message_bits (7 selects
                N=4096) instead of the smallest preset that fits the
                circuit's widest TLU; the circuit must fit it

The model is drawn at random from a seed, calibrated on 64 synthetic
images (scales, then one train-mode forward for the BatchNorm statistics,
``bench.py``'s order) and lowered twice at rounding 6, range_margin 1.0:
fused (the headline) and requant-literal (the reference's graph).  The
noise audit at p_error 0.01 picks every knob, as in ``bench.py``.  Keys
come from a real keygen (seed 0) on the host.  Each knob's rate comes
from one production chunk of fresh ciphertexts: one warm-up call, then the
host clock around one call ending in ``torch.cuda.synchronize()``
(``benchmark/rates.py``'s timing).  Under ``BENCH_PRESET`` the drop-0
chunk is decrypted and held to its tables.

Where it differs from ``bench.py``: torch cannot reproduce
``init_model(jax.random.key(0))``, so the weights are
``init_model(spec, torch.Generator().manual_seed(0))``; the calibrated bit
widths, and with them the bootstrap counts, differ from ``bench.py``'s by
that draw.  ``tests/test_torch_resnet18.py`` holds the port's counts
against ``bench.circuit_pbs_totals`` on the JAX package's own weights.

Prints ``#`` lines on stderr, then on stdout the card's name and power
limit and, as the last line,
  {"metric": "pbs_per_sec", "value": <PBS/s>, "unit": "PBS/s",
   "vs_baseline": <the reference's seconds per image / the estimate>}
Needs one NVIDIA GPU and nvcc; exits nonzero without a GPU.
"""
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import common  # noqa: E402
from benchmark.rates import circuit_pbs_totals  # noqa: E402
from dct_cryptonets_tpu_torch.data.codec import (CodecConfig,  # noqa: E402
                                                 make_ingest)
from dct_cryptonets_tpu_torch.data.pipeline import load_synthetic  # noqa: E402
from dct_cryptonets_tpu_torch.fhe import (decrypt_lwe,  # noqa: E402
                                          encrypt_lwe)
from dct_cryptonets_tpu_torch.fhe import kernels as K  # noqa: E402
from dct_cryptonets_tpu_torch.fhe import pbs as P  # noqa: E402
from dct_cryptonets_tpu_torch.fhe import torus as T  # noqa: E402
from dct_cryptonets_tpu_torch.fhe.compiler import lower  # noqa: E402
from dct_cryptonets_tpu_torch.fhe.noise_audit import (  # noqa: E402
    audit_circuit)
from dct_cryptonets_tpu_torch.fhe.params import (  # noqa: E402
    _PRESETS, default_exact_rounding, params_for_precision)
from dct_cryptonets_tpu_torch.fhe.runtime import CompiledModule  # noqa: E402
from dct_cryptonets_tpu_torch.homomorphic_eval import (  # noqa: E402
    calibrate_random_init)
from dct_cryptonets_tpu_torch.models.resnet import (build_spec,  # noqa: E402
                                                    init_model)

# s per image on a CPU: reference README.md:84 (ResNet-20) and :88
# (ResNet-18), bench.py's REF_LATENCY
REF_LATENCY = {"ResNet20qat": 565.0, "ResNet18qat": 1004.0}
# (channels, filter_size, image_size_dct) of each model's CIFAR-10 DCT
# preset (bench.build_circuits)
CODEC = {"ResNet20qat": (24, 4, 16), "ResNet18qat": (6, 8, 32)}
SHIFT = 4       # representative per-TLU extraction depth (bench.py's)
P_ERROR = 0.01


def knobs(env=None) -> dict:
    """``bench.py``'s four knobs from the environment, with its defaults
    on an accelerator."""
    env = os.environ if env is None else env
    model = env.get("BENCH_MODEL", "ResNet20qat")
    mode = env.get("BENCH_MODE", "exact")
    if model not in REF_LATENCY:
        raise ValueError(f"BENCH_MODEL {model!r}: one of "
                         f"{sorted(REF_LATENCY)}")
    if mode not in ("exact", "approximate"):
        raise ValueError(f"BENCH_MODE {mode!r}: exact or approximate")
    preset = env.get("BENCH_PRESET")
    return {"M": int(env.get("BENCH_M", 2048)), "mode": mode, "model": model,
            "preset": int(preset) if preset else None}


def build_circuits(model: str, device):
    """(fused circuit, requant-literal circuit) of ``model`` drawn from
    seed 0 and calibrated on 64 synthetic images at its CIFAR-10 DCT
    preset."""
    ch, fs, size = CODEC[model]
    cfg = CodecConfig(channels=ch, filter_size=fs, image_size_dct=size)
    spec = build_spec(model, in_channels=ch, img_size=size, num_classes=10,
                      bit_width=4)
    ds = load_synthetic(64, cfg.pixel_size, 10, seed=0)
    x = make_ingest(cfg, device)(ds.images)
    params, state = calibrate_random_init(
        *init_model(spec, torch.Generator().manual_seed(0)), x, spec)
    kw = dict(rounding_threshold_bits=6, calib_data=x, range_margin=1.0)
    return (lower(params, state, spec, residual_mode="fused", **kw),
            lower(params, state, spec, residual_mode="requant", **kw))


def chunk_inputs(m, rng, M, bits):
    """(fresh ciphertexts of random ``bits``-bit messages, the messages,
    random tables in [-7, 8)): ``benchmark.common.main_chunk``'s draw."""
    ck = m.client_keys
    msgs = rng.integers(0, 2 ** bits, M)
    ct = T.from_u64(encrypt_lwe(
        ck, msgs.astype(np.uint64) << np.uint64(64 - bits - 1), rng,
        key=ck.big_lwe_key, noise_log2=m.params.glwe_noise_log2), m.device)
    return ct, msgs, rng.integers(-7, 8, (M, 2 ** bits))


def decrypt_errors(m, out, msgs, tab):
    """(neighbour-window slips, other errors) of bootstrap outputs against
    their tables.  A slip reads the next window (negacyclic at the ends),
    as the noise model's per-PBS error does; anything else is a fault."""
    ck, M, n = m.client_keys, len(msgs), tab.shape[1]
    phase = decrypt_lwe(ck, T.to_u64(out), key=ck.big_lwe_key)
    dec = np.round(phase.astype(np.int64).astype(np.float64)
                   / 2.0 ** m.params.delta_log2).astype(np.int64)
    rows = np.arange(M)
    up = np.where(msgs == n - 1, -tab[:, 0], tab[rows, (msgs + 1) % n])
    down = np.where(msgs == 0, -tab[:, -1], tab[rows, msgs - 1])
    bad = dec != tab[rows, msgs]
    gross = bad & (dec != up) & (dec != down)
    return int((bad & ~gross).sum()), int(gross.sum())


def chunk_rates(m, knob_set, M, bits, exact, check):
    """({knob: main PBS/s}, extractions/s or None); with ``check`` the
    drop-0 chunk's outputs are decrypted and must equal their tables but
    for at most p_error neighbour-window slips."""
    rng = np.random.default_rng(7)
    rates = {}
    for drop, cross in sorted(knob_set):
        ct, msgs, tab = chunk_inputs(m, rng, M, bits)
        tables = torch.as_tensor(tab, dtype=torch.int32, device=m.device)

        def fn(drop=drop, cross=cross):
            return P.bootstrap(ct, tables, m.device_keys, m.params,
                               m.params.delta_log2, drop, cross)
        out, warm = common.timed(fn, m.device)
        _, dt = common.timed(fn, m.device)
        rates[(drop, cross)] = M / dt
        print(f"# main drop={drop}+x{cross}: warm-up {warm:.2f}s, {dt:.2f}s "
              f"per {M}-PBS batch -> {rates[(drop, cross)]:.1f} PBS/s",
              file=sys.stderr, flush=True)
        if check and (drop, cross) == (0, 0):
            slips, gross = decrypt_errors(m, out, msgs, tab)
            print(f"# main drop=0 chunk decrypts to its tables: "
                  f"{M - slips - gross}/{M} (neighbour-window slips {slips}, "
                  f"other errors {gross})", file=sys.stderr, flush=True)
            if gross or slips > P_ERROR * M:
                raise AssertionError(f"the preset-{m.params.message_bits} "
                                     f"chunk decrypts wrong: {slips} slips, "
                                     f"{gross} other errors of {M}")
    aux_rate = None
    if exact:
        Ma = 2 * M
        fn = common.aux_chunk(m, rng, Ma, shift=SHIFT)
        _, warm = common.timed(fn, m.device)
        _, dt = common.timed(fn, m.device)
        aux_rate = Ma * SHIFT / dt
        print(f"# aux: warm-up {warm:.2f}s, {dt:.2f}s per {Ma}x{SHIFT} "
              f"extraction batch -> {aux_rate:.1f} extractions/s",
              file=sys.stderr, flush=True)
    return rates, aux_rate


def estimate(label, by_knob, aux_count, rates, aux_rate, mode, ref_s):
    """(main seconds, image seconds) of one circuit at the measured rates
    (``bench.py``'s estimate line)."""
    main_s = sum(sites / rates[knob] for knob, sites in by_knob.items())
    aux_s = aux_count / aux_rate if (aux_rate and aux_count) else 0.0
    est = main_s + aux_s
    print(f"# {mode}-rounding {label} image estimate: main {main_s:.1f}s"
          f" + extractions {aux_s:.1f}s = {est:.1f}s (ref {ref_s}s exact)",
          file=sys.stderr, flush=True)
    return main_s, est


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_model.py: no CUDA device; the rates are the card's",
              file=sys.stderr)
        return 2
    print(f"# kernel build {K.build_kernels():.1f}s", file=sys.stderr,
          flush=True)
    return run(knobs(), torch.device("cuda"), common.card_line())


def run(k: dict, device, card: str) -> int:
    """The bench at knobs ``k`` on ``device``."""
    print(f"# knobs {k}", file=sys.stderr, flush=True)
    circ, circ_req = build_circuits(k["model"], device)
    max_r = common.max_tlu_bits(circ)
    if k["preset"] is not None:
        params = _PRESETS[k["preset"]]
        assert params.message_bits >= max_r, (params, max_r)
    else:
        params = params_for_precision(max_r)
    cfg = default_exact_rounding(params)
    M, exact = k["M"], k["mode"] == "exact"
    m = CompiledModule(circ, params, pbs_batch=M, aux_batch=2 * M,
                       exact_cfg=cfg, drop_policy="audit", p_error=P_ERROR,
                       device=device)
    # the audit picks the per-layer (drop, cross) knobs and the
    # extraction's, as in bench.py
    audit = m.run_audit()
    audit_req = audit_circuit(circ_req, params, p_error=P_ERROR,
                              exact_cfg=cfg)
    by_knob, num_aux = circuit_pbs_totals(circ, audit)
    by_knob_req, num_aux_req = circuit_pbs_totals(circ_req, audit_req)
    num_pbs = sum(by_knob.values())
    print(f"# {k['model']} circuit: {num_pbs} PBS/image at knobs "
          f"{sorted(by_knob.items())} + {num_aux} exact-rounding "
          f"extractions, max TLU bits {max_r}, max acc bits "
          f"{circ.max_bit_width()}, audited p_error "
          f"{audit.max_p_error:.2e}", file=sys.stderr)
    print(f"# requant-literal circuit: {sum(by_knob_req.values())} PBS/image"
          f" at knobs {sorted(by_knob_req.items())} + {num_aux_req} "
          f"extractions, audited p_error {audit_req.max_p_error:.2e}",
          file=sys.stderr)
    print(f"# params: n={params.lwe_dim} N={params.poly_size} "
          f"l={params.pbs_levels} B=2^{params.pbs_base_log}; M={M}; "
          f"aux n={cfg.aux.lwe_dim} k={cfg.aux.glwe_dim} "
          f"N={cfg.aux.poly_size} drop={audit.aux_drop_limbs}"
          f"+x{audit.aux_cross} ks_drop fwd={audit.aux_fwd_ks_drop}"
          f"/back={audit.aux_back_ks_drop}", file=sys.stderr, flush=True)
    m.keygen(seed=0)
    print(f"# keygen {m.stats['keygen_time']:.1f}s", file=sys.stderr,
          flush=True)
    rates, aux_rate = chunk_rates(
        m, set(by_knob) | set(by_knob_req) | {(0, 0)}, M, max_r, exact,
        check=k["preset"] is not None)
    ref_s = REF_LATENCY[k["model"]]
    main_s, est = estimate("fused", by_knob, num_aux, rates, aux_rate,
                           k["mode"], ref_s)
    estimate("requant-literal", by_knob_req, num_aux_req, rates, aux_rate,
             k["mode"], ref_s)
    print(card)
    print(json.dumps({"metric": "pbs_per_sec",
                      "value": round(num_pbs / main_s, 2), "unit": "PBS/s",
                      "vs_baseline": round(ref_s / est, 3)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
