#!/usr/bin/env python3
"""Whole encrypted ResNet-18 CIFAR images on the card, one per seed.

    python3 dct_cryptonets_tpu_torch/tools/resnet18_image.py [--seeds 0 1 2]

The configuration is ``bench.py``'s ResNet18qat row (the reference's
CIFAR-10 ResNet-18 DCT row, 1,004 s per image on a CPU, README.md:88):
DCT 6 ch x 32^2 through the fs-8 codec, bit_width 4, n_bits 5, rounding 6
exact, fused residuals, range_margin 1.0, ``drop_policy="audit"`` at
p_error 0.01 with the main bootstraps at drop 0 (the eval CLI's
``--drop_limbs`` default), bootstrap batch 4096 on both lattices.  The
weights are the eval CLI's random model (``homomorphic_eval.prepare``
without a checkpoint: ``init_model`` from seed 0, calibrated on the
first 64 synthetic training images); the compile picks preset 6 (N=2048)
and k2n512f.

Each seed picks the image (the CLI's seeded test subset), the keys
(keygen from the seed, on the host) and the encryption noise, and runs
``benchmark.run.measure``: the audit, keygen, one warm-up chunk per
lattice, then ``forward(fhe="execute", drop_limbs=0, check_ref=True)``
with the realized-slip audit, simulate, the clear model, and one
``torch.profiler`` pass per lattice.  Printed per seed: the realized
slips per TLU layer and in all, the class from execute, simulate and the
clear model, ``execute_time`` with its main / extraction / levelled
split, keygen and audit seconds, ``max_memory_allocated``, the K1-K3
launch counts, and one JSON line of every metric; then the spread of
``execute_time`` over the seeds, and the card's name and power limit.

A seed fails when its slip share exceeds p_error, when the three classes
are not one, or when ``measure`` reports a failure (K1-K3 not launched,
bootstrap counts off the circuit's); the tool then exits 1.  Needs one
NVIDIA GPU and nvcc.
"""
import argparse
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import common  # noqa: E402
from benchmark.run import measure, seeded_image  # noqa: E402
from dct_cryptonets_tpu_torch import homomorphic_eval as HE  # noqa: E402
from dct_cryptonets_tpu_torch.fhe import kernels as K  # noqa: E402
from dct_cryptonets_tpu_torch.fhe.params import (  # noqa: E402
    default_exact_rounding)

P_ERROR = 0.01
ARGS = ["--dataset", "synthetic", "--dct_status", "--model", "ResNet18qat",
        "--channels", "6", "--filter_size", "8", "--image_size_dct", "32",
        "--bit_width", "4", "--n_bits", "5", "--rounding_threshold_bits", "6",
        "--rounding_method", "exact", "--residual_mode", "fused",
        "--range_margin", "1.0", "--drop_policy", "audit", "--p_error",
        str(P_ERROR), "--pbs_batch", "4096", "--fhe_mode", "execute",
        "--test_subset", "1"]
PATH_KERNELS = ("rotate_decompose", "build_bigd_strips", "fused_external")


def prepare(device):
    """The compiled ResNet18qat module (no keys yet) through the eval
    flow, and the set-up seconds."""
    t = time.time()
    s = HE.prepare(HE.parse_args("homomorphic_eval", ARGS), device)
    m = s.module
    m.aux_batch = 4096
    aux = default_exact_rounding(m.params).aux   # the audit's, in measure
    print(f"  prepare (synthetic data, random model, calibrated compile): "
          f"{time.time() - t:.1f} s; {m.circuit.num_pbs} main PBS per image,"
          f" max acc bits {m.maximum_integer_bit_width()}\n  main "
          f"{m.params}\n  aux {aux}", flush=True)
    if (m.params.poly_size, aux.poly_size) != (2048, 512):
        raise AssertionError("expected preset 6 and k2n512f")
    return s, time.time() - t


def one_image(s, seed, setup, device):
    """measure() on the seed's image; prints its lines and returns
    (ok, metrics)."""
    m = s.module
    x, label = seeded_image(s, seed)
    clf = (np.asarray(s.params["classifier"]["w"]),
           np.asarray(s.params["classifier"]["b"]))
    res = measure(m, x, clf, seed=seed, limits={"slip_share": P_ERROR},
                  drop_limbs=0, clear_model=s.model, setup=setup,
                  device=device)
    met, st = res["metrics"], m.stats
    for wire, n_bad, n, n_gross, max_abs in st["tlu_slip_detail"]:
        print(f"  seed {seed} slips {wire}: {n_bad}/{n} (|d| > 1: "
              f"{n_gross}, max |d| {max_abs})", flush=True)
    slips, sites = st["tlu_slips"], st["tlu_sites"]
    cls = res["classes"]
    print(f"  seed {seed}: realized TLU slips {slips}/{sites} = "
          f"{slips / sites:.5f} (p_error {P_ERROR}); class execute "
          f"{cls['execute']}, simulate {cls['simulate']}, clear "
          f"{cls['clear']}, label {label}", flush=True)
    print(f"  seed {seed}: execute_time {met['image_s']:.3f} s = main "
          f"{met['main_pbs_s']:.3f} + extraction {met['extract_s']:.3f} + "
          f"levelled {met['levelled_s']:.3f} s (+ glue); "
          f"{met['main_pbs']} main PBS at {met['pbs_per_sec']:.1f}/s, "
          f"{met['extractions']} extractions at "
          f"{met['extractions_per_sec']:.1f}/s; keygen {met['keygen_s']:.1f}"
          f" s, audit {met['audit_s']:.2f} s; max_memory_allocated "
          f"{met['peak_mem_gb']:.2f} GB; launches {res['launches']}",
          flush=True)
    failures = list(res["failures"])
    if len(set(cls.values())) != 1:
        failures.append(f"classes differ: {cls}")
    if any(res["launches"][k] == 0 for k in PATH_KERNELS):
        failures.append("K1-K3 not all launched")
    print(json.dumps({"seed": seed, "ok": not failures,
                      "failures": failures, "classes": cls,
                      "launches": res["launches"], "metrics": met}),
          flush=True)
    return not failures, met


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("resnet18_image: needs one NVIDIA GPU", file=sys.stderr)
        return 2
    card = common.card_line()
    print(card, flush=True)
    device = torch.device("cuda")
    setup = {"build_s": K.build_kernels()}
    s, setup["compile_s"] = prepare(device)
    results = {}
    for seed in args.seeds:
        results[seed] = one_image(s, seed, setup, device)
    times = [met["image_s"] for _, met in results.values()]
    med = float(np.median(times))
    print(f"execute_time over seeds {args.seeds}: " + ", ".join(
        f"{t:.3f}" for t in times) + f" s; median {med:.3f} s, spread "
        f"(max - min) / median {100 * (max(times) - min(times)) / med:.2f} %",
        flush=True)
    print(card, flush=True)
    return 0 if all(ok for ok, _ in results.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
