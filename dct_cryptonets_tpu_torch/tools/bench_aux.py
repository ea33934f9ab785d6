#!/usr/bin/env python3
"""The exact-rounding extraction throughput on the card, counterpart of
the JAX package's ``tools/bench_aux.py``.

    python3 dct_cryptonets_tpu_torch/tools/bench_aux.py

One extraction = one ``clear_low_bits`` bit step: forward keyswitch from
the main big key into the aux small set, mod switch, N_aux blind rotate,
sample extract, back keyswitch, subtract.  It dominates exact-rounding
(Concrete-default) encrypted inference.  The keys are the JAX tool's
(main client keys from seed 0, the aux server keys from seed 2; preset
6), made on the host at each run; the chunk runs on the kernel engine.

Env: BENCH_M (default 2048), BENCH_SHIFT (bits cleared per call, default
4), BENCH_AUX_DROP (default 3), BENCH_AUX_CROSS (default 0),
BENCH_EXTRACT (extraction preset name from ``params.EXTRACT_PRESETS``,
default ``params.DEFAULT_EXTRACT``).  Needs one NVIDIA GPU and nvcc.
"""
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark.common import card_line, timed  # noqa: E402
from dct_cryptonets_tpu_torch.fhe import torus as T  # noqa: E402
from dct_cryptonets_tpu_torch.fhe.keys import (encrypt_lwe,  # noqa: E402
                                               keygen, make_aux_server_keys)
from dct_cryptonets_tpu_torch.fhe.params import (  # noqa: E402
    default_exact_rounding, params_for_precision)
from dct_cryptonets_tpu_torch.fhe.pbs import (  # noqa: E402
    clear_low_bits, preprocess_aux_keys)


def main():
    if not torch.cuda.is_available():
        print("bench_aux: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(card_line(), flush=True)
    M = int(os.environ.get("BENCH_M", 2048))
    shift = int(os.environ.get("BENCH_SHIFT", 4))
    params = params_for_precision(6)
    cfg = default_exact_rounding(
        params, extract=os.environ.get("BENCH_EXTRACT") or None)
    drop = int(os.environ.get("BENCH_AUX_DROP", 3))
    cross = int(os.environ.get("BENCH_AUX_CROSS", 0))
    n_in = 13
    print(f"# aux set: n={cfg.aux.lwe_dim} k={cfg.aux.glwe_dim} "
          f"N={cfg.aux.poly_size} drop={drop} cross={cross}",
          file=sys.stderr)

    ck = keygen(params, seed=0)
    t = time.time()
    ak = make_aux_server_keys(ck, cfg.aux, seed=2,
                              back_base_log=cfg.back_base_log,
                              back_levels=cfg.back_levels)
    print(f"# aux keygen {time.time()-t:.1f}s", file=sys.stderr)
    dak = preprocess_aux_keys(ak, dev)

    rng = np.random.default_rng(3)
    v = rng.integers(0, 2 ** n_in, M).astype(np.uint64)
    mu = v << np.uint64(63 - n_in)
    ct = T.from_u64(encrypt_lwe(ck, mu, rng, key=ck.big_lwe_key,
                                noise_log2=params.glwe_noise_log2), dev)

    def run(c):
        return clear_low_bits(c, dak, cfg.aux, n_in, shift,
                              cfg.back_base_log, cfg.back_levels,
                              drop_limbs=drop, cross=cross)

    _, first = timed(lambda: run(ct), dev)
    print(f"# compile+first {first:.1f}s", file=sys.stderr)

    iters = 3

    def chain():
        cur = ct
        for _ in range(iters):
            cur = run(cur)   # chained: output is a valid same-shape ciphertext
        return cur

    _, dt = timed(chain, dev)
    dt /= iters
    rate = M * shift / dt
    print(f"# {dt:.2f}s per {M}x{shift} extraction batch "
          f"(drop={drop}) -> {rate:.1f} extractions/s")
    print(f"# ratio vs one main PBS: "
          f"{rate and (1.0 / rate):.6f}s each", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
