#!/usr/bin/env python3
"""A compiled circuit's PBS cost structure, counterpart of the JAX
package's ``tools/circuit_cost.py``: the same flags, table and totals,
from this package's compiler.

    python3 dct_cryptonets_tpu_torch/tools/circuit_cost.py [--calib]
        [--rounding R] [--model M] [--channels C] [--img S]

For every TLU layer: sites per sample, accumulator budget n, table bits
r, shift (= aux extraction bootstraps per site in exact-rounding mode),
and the blind-rotate work in main-PBS units (cost ~ n_lwe * N^2 at equal
gadget settings); then the totals of both rounding methods.  The model is
drawn at random (``init_model``, seed 0, which draws other weights than
the JAX package's ``jax.random.key(0)``), its activation scales and
BatchNorm statistics set on 64 synthetic images, as in the JAX tool.
Host only: runs on the CPU of any machine.
"""
import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def build_circuit(args):
    """The tool's circuit: a random model of ``args.model``, calibrated on
    64 synthetic images, lowered at ``args.rounding`` threshold bits."""
    from dct_cryptonets_tpu_torch.data import CodecConfig, dct_ingest
    from dct_cryptonets_tpu_torch.data.pipeline import load_synthetic
    from dct_cryptonets_tpu_torch.fhe.compiler import lower
    from dct_cryptonets_tpu_torch.homomorphic_eval import \
        calibrate_random_init
    from dct_cryptonets_tpu_torch.models.resnet import build_spec, init_model

    cfg = CodecConfig(channels=args.channels, filter_size=4,
                      image_size_dct=args.img)
    spec = build_spec(args.model, in_channels=args.channels,
                      img_size=args.img, num_classes=10, bit_width=4)
    params, state = init_model(spec)
    x = dct_ingest(load_synthetic(64, 64, 10, seed=0).images, cfg)
    params, state = calibrate_random_init(params, state, x, spec)
    return lower(params, state, spec, rounding_threshold_bits=args.rounding,
                 calib_data=x if args.calib else None)


def cost_lines(circ) -> list:
    """The JAX tool's printed lines for ``circ``: the per-TLU table, the
    lattices and the totals."""
    from dct_cryptonets_tpu_torch.fhe.circuit import Tlu
    from dct_cryptonets_tpu_torch.fhe.params import (default_exact_rounding,
                                                     params_for_precision)

    max_r = max(op.spec.in_bits for op in circ.ops if isinstance(op, Tlu))
    main = params_for_precision(max_r)
    aux = default_exact_rounding(main).aux
    # blind-rotate work ~ n * N^2 (same gadget levels); 1.0 = one main PBS
    aux_unit = (aux.lwe_dim * aux.poly_size ** 2) / (
        main.lwe_dim * main.poly_size ** 2)
    shapes = circ.meta["shapes"]
    lines = [f"{'tensor':<10} {'sites':>8} {'n':>3} {'r':>2} {'shift':>5} "
             f"{'mainPBS':>9} {'auxPBS':>9}"]
    tot_sites = tot_aux = 0
    for op in circ.ops:
        if not isinstance(op, Tlu):
            continue
        sites = int(np.prod(shapes[op.x]))
        n_in = op.spec.in_bits + op.spec.shift
        aux_n = sites * op.spec.shift
        tot_sites += sites
        tot_aux += aux_n
        lines.append(f"{op.x:<10} {sites:>8} {n_in:>3} {op.spec.in_bits:>2} "
                     f"{op.spec.shift:>5} {sites:>9} {aux_n:>9}")
    eq_exact = tot_sites + tot_aux * aux_unit
    lines += [
        f"\nmain set: n={main.lwe_dim} N={main.poly_size}; "
        f"aux set: n={aux.lwe_dim} N={aux.poly_size} "
        f"(aux BR work = {aux_unit:.3f} main-PBS units)",
        f"max acc bit-width: {circ.max_bit_width()} (<=16 required)",
        f"PBS/image (main TLUs):            {tot_sites:>10}",
        f"aux extraction bootstraps/image:  {tot_aux:>10}",
        f"approximate-mode cost (main-PBS units): {tot_sites:>12.0f}",
        f"exact-mode cost       (main-PBS units): {eq_exact:>12.0f} "
        f"({eq_exact / tot_sites:.2f}x)"]
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--calib", action="store_true",
                    help="use calibration-based accumulator budgets")
    ap.add_argument("--rounding", type=int, default=6)
    ap.add_argument("--model", default="ResNet20qat")
    ap.add_argument("--channels", type=int, default=24)
    ap.add_argument("--img", type=int, default=16)
    args = ap.parse_args(argv)
    for line in cost_lines(build_circuit(args)):
        print(line)


if __name__ == "__main__":
    main()
