#!/usr/bin/env python3
"""The flagship image at the noise audit's own main knobs, and the main
bootstrap's output noise at each of those knobs against the noise model.

    python3 dct_cryptonets_tpu_torch/tools/audit_image.py

Prepares the smoke's flagship module (checkpoint, calibrated compile,
keygen from seed 0; ``chip_smoke.prepare_slice``), then:

1. one production chunk of 4096 fresh ciphertexts through the main
   bootstrap (preset 6, kernel engine) at (drop, cross) = (0, 0) and at
   every main knob the audit picks: the standard deviation of the output
   error (decrypted phase less table value, the slipped windows left out)
   beside the noise model's (``NoiseModel.var_blind_rotate`` plus
   ``var_drop_limbs`` and ``var_drop_cross``: the variance the audit
   charges a consumer for that knob);
2. the smoke's image under ``drop_policy="audit"``
   with the audit's per-layer main knobs (``drop_limbs=None``) and the
   realized-slip audit: realized slips per layer beside the audit's
   modeled per-PBS p (``chip_smoke.phase_audited``, not enforced).

Needs one NVIDIA GPU and nvcc.
"""
import math
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import chip_smoke as CS  # noqa: E402
from dct_cryptonets_tpu_torch.fhe import (NoiseModel, decrypt_lwe,  # noqa: E402
                                          encrypt_lwe)
from dct_cryptonets_tpu_torch.fhe import kernels as K  # noqa: E402
from dct_cryptonets_tpu_torch.fhe import pbs as P  # noqa: E402
from dct_cryptonets_tpu_torch.fhe import torus as T  # noqa: E402
from dct_cryptonets_tpu_torch.fhe.runtime import CompiledModule  # noqa: E402


def output_noise(m, dev, knobs, M=4096, r=6, out_log2=51):
    """Measured against modeled log2 std of the bootstrap's output error
    at each (drop, cross) knob, on the same inputs and tables."""
    par, ck = m.params, m.client_keys
    nm = NoiseModel(par)
    rng = np.random.default_rng(21)
    msgs = rng.integers(0, 2 ** r, M)
    ct = T.from_u64(encrypt_lwe(
        ck, msgs.astype(np.uint64) << np.uint64(64 - r - 1), rng,
        key=ck.big_lwe_key, noise_log2=par.glwe_noise_log2), dev)
    tab = rng.integers(-2 ** 11, 2 ** 11, (M, 2 ** r))
    tables = torch.as_tensor(tab, dtype=torch.int32, device=dev)
    want = (tab[np.arange(M), msgs].astype(np.int64).astype(np.uint64)
            << np.uint64(out_log2))
    for drop, cross in knobs:
        out, secs = CS.timed(lambda: P.bootstrap(
            ct, tables, m.device_keys, par, out_log2, drop, cross))
        phase = decrypt_lwe(ck, T.to_u64(out), key=ck.big_lwe_key)
        with np.errstate(over="ignore"):
            err = (phase - want).astype(np.int64)
        ok = np.abs(err) < 2 ** (out_log2 - 2)       # slipped windows out
        var = (nm.var_blind_rotate() + nm.var_drop_limbs(drop)
               + (nm.var_drop_cross(drop) if cross else 0.0))
        if ok.sum() > 1:
            std = max(float(np.std(err[ok].astype(np.float64))), 1.0)
            got = (f"std 2^{math.log2(std):.2f} measured, 2^"
                   f"{0.5 * math.log2(var):.2f} modeled (variance ratio "
                   f"{std * std / var:.2f})")
        else:
            got = (f"no output within a quarter window (modeled std 2^"
                   f"{0.5 * math.log2(var):.2f})")
        print(f"  bootstrap M={M} drop={drop} cross={cross}: output error "
              f"{got}; slipped windows {int((~ok).sum())}/{M}; {secs:.2f} s",
              flush=True)


def main():
    if not torch.cuda.is_available():
        print("audit_image: needs one NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(f"kernel build: {K.build_kernels():.1f} s", flush=True)
    s = CS.prepare_slice(dev)
    m = s.module
    audit = CompiledModule(m.circuit, m.params, exact_cfg=m.exact_cfg,
                           drop_policy="audit", p_error=CS.P_ERROR,
                           device=dev).run_audit()
    knobs = sorted({(r.drop_limbs, r.cross) for r in audit.reports}
                   | {(0, 0)})
    output_noise(m, dev, knobs)
    CS.phase_audited(s, dev, drop_limbs=None, enforce=False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
