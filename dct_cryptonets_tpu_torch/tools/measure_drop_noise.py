#!/usr/bin/env python3
"""The blind rotate's output noise per (drop_limbs, cross) knob on the
card, counterpart of the JAX package's ``tools/measure_drop_noise.py``.

    python3 dct_cryptonets_tpu_torch/tools/measure_drop_noise.py

A CONSTANT test polynomial makes window slips invisible, so the decrypted
phase residual is exactly the blind-rotate output noise, the quantity
``NoiseModel.var_blind_rotate`` / ``var_drop_limbs`` / ``var_drop_cross``
predict.  Preset 6 under the JAX tool's keys (client keys from seed 0,
server keys from seed 1), 2,048 fresh ciphertexts of 6-bit messages, one
bootstrap per knob on the kernel engine; prints the measured standard
deviation beside the model's, as the JAX tool does, and then again
without the ciphertexts whose bootstrap slipped across the negacyclic
edge (message 0 read one window low or 63 one high: the constant table
reads -C there, an error of 2C windows that outweighs the noise of all
the others; the same ciphertexts at every knob, found at (0, 0)).
Needs one NVIDIA GPU and nvcc.
"""
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark.common import card_line  # noqa: E402
from dct_cryptonets_tpu_torch.fhe import torus as T  # noqa: E402
from dct_cryptonets_tpu_torch.fhe.keys import (decrypt_lwe,  # noqa: E402
                                               encrypt_lwe, keygen,
                                               make_server_keys)
from dct_cryptonets_tpu_torch.fhe.params import (  # noqa: E402
    NoiseModel, params_for_precision)
from dct_cryptonets_tpu_torch.fhe.pbs import (  # noqa: E402
    bootstrap, preprocess_server_keys)

KNOBS = ((0, 0), (3, 0), (3, 1), (4, 0), (4, 1))


def main():
    if not torch.cuda.is_available():
        print("measure_drop_noise: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(card_line(), flush=True)
    params = params_for_precision(6)
    ck = keygen(params, seed=0)
    dsk = preprocess_server_keys(make_server_keys(ck, seed=1), dev)
    nm = NoiseModel(params)
    M, bits = 2048, 6
    rng = np.random.default_rng(11)
    msgs = rng.integers(0, 2 ** bits, M)
    mu = msgs.astype(np.uint64) << np.uint64(64 - bits - 1)
    ct = T.from_u64(encrypt_lwe(ck, mu, rng, key=ck.big_lwe_key,
                                noise_log2=params.glwe_noise_log2), dev)
    # constant table: window slips are invisible -> residual = BR output noise
    C = 17
    table = torch.full((M, 2 ** bits), C, dtype=torch.int32, device=dev)
    delta_out = params.delta_log2
    flip = None
    for drop, cross in KNOBS:
        out = bootstrap(ct, table, dsk, params, delta_out,
                        drop_limbs=drop, cross=cross)
        phase = decrypt_lwe(ck, T.to_u64(out), key=ck.big_lwe_key)
        want = np.uint64(C) << np.uint64(delta_out)
        err = (phase - want).astype(np.int64)
        sigma = err.std()
        pred = (nm.var_blind_rotate() + nm.var_drop_limbs(drop)
                + (nm.var_drop_cross(drop) if cross else 0.0)) ** 0.5
        print(f"drop={drop} cross={cross}: measured sigma "
              f"2^{np.log2(max(sigma, 1)):.2f} model 2^{np.log2(pred):.2f}",
              flush=True)
        # a slip across the negacyclic edge (message 0 down, 63 up) reads
        # -C, an error of about 2C windows that the constant table does
        # not hide.  The mod switch, before the rotate, decides it, so the
        # same ciphertexts slip at every knob: found at (0, 0), where the
        # rotate's noise is far below a window, and left out at each
        if flip is None:
            flip = np.abs(err.astype(np.float64)) > 2.0 ** (delta_out - 1)
        rest = err[~flip].astype(np.float64).std()
        print(f"  without the {int(flip.sum())} ciphertexts that slip across "
              f"the negacyclic edge: measured sigma "
              f"2^{np.log2(max(rest, 1)):.2f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
