#!/usr/bin/env python3
"""What bounds K1 (``csrc/rotate_decompose.cu``) and K2
(``csrc/bigd_strips.cu``) on the card.

    python3 dct_cryptonets_tpu_torch/tools/k1_k2_bound.py [--other NAME=DIR]

Builds the kernel library from the committed sources as they stand and
with K1's digit arithmetic taken out (each thread writes the low bytes of
its two shared-memory reads instead: the loads, the staging and the
stores alone), and, for each ``--other``, from the CUDA sources in DIR
(say an earlier tree's ``csrc/``).  Then times, in turns, with CUDA
events behind a spin kernel (so the host's launch costs are not counted): K1
plane-major at the smoke's shapes (main J=2, N=2048 at M=2048 and 4096;
aux J=3, N=512, M=4096; 15-bit digits, 2 levels) and K2 K-major (main
G=64, N=2048; aux G=144, N=512), each beside a ``zero_()`` of its output
(the card's write rate on the same bytes).  Only the libraries of real
kernels are checked against the plain versions; the K1 variant computes
garbage by design.  Needs one NVIDIA GPU and nvcc.
"""
import argparse
import os
import shutil
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from dct_cryptonets_tpu_torch.fhe import kernels as K  # noqa: E402

DIGITS = """      const uint32_t top = (uint32_t)((diff + rnd) >> ksh);
      int carry = 0;"""
NO_DIGITS = """      const uint32_t top = (uint32_t)diff;
      for (int p = 0; p < lg; ++p) {
        planes[(2 * p) * N + x] = (signed char)top;
        planes[(2 * p + 1) * N + x] = (signed char)(top >> 8);
      }
      if (rnd != 0) continue;
      int carry = 0;"""
VARIANTS = {"kernel": [], "K1 memory only": [(DIGITS, NO_DIGITS)]}
K1_SHAPES = {"main M=2048": (2, 2048, 2048), "main M=4096": (2, 2048, 4096),
             "aux M=4096": (3, 512, 4096)}
K2_SHAPES = {"main": (2, 32, 2048), "aux": (3, 48, 512)}
BUILD = os.path.join(ROOT, "build", "k1_k2_bound")
SPIN_CYCLES = 4_000_000      # about 2 ms: longer than the host takes to queue


def build(name, csrc, edits):
    """The kernel library from csrc with K1's source edited; returns its
    ctypes handle (the wrappers launch whatever ``K._lib`` holds)."""
    src = os.path.join(BUILD, name.replace(" ", "_"), "csrc")
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(csrc, src)
    path = os.path.join(src, "rotate_decompose.cu")
    with open(path) as fh:
        text = fh.read()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"{name}: the source no longer has {old!r}")
        text = text.replace(old, new)
    with open(path, "w") as fh:
        fh.write(text)
    K._lib = None
    K.CSRC_DIR, K.BUILD_ROOT = src, os.path.join(os.path.dirname(src),
                                                 "cuda")
    K.build_kernels()
    return K._lib


def cuda_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", action="append", default=[],
                    metavar="NAME=DIR",
                    help="also time the CUDA sources in DIR (repeatable)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_k2_bound: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip() or "nvidia-smi unavailable", flush=True)
    csrc = K.CSRC_DIR
    libs = {name: build(name, csrc, edits)
            for name, edits in VARIANTS.items()}
    for other in args.other:
        name, path = other.split("=", 1)
        libs[name] = build(name, path, [])
    gen = torch.Generator(device="cuda").manual_seed(7)
    k1 = {}
    for what, (J, N, M) in K1_SHAPES.items():
        acc = torch.randint(-2 ** 63, 2 ** 63 - 1, (J, M, N), generator=gen,
                            device="cuda", dtype=torch.int64)
        amt = torch.randint(0, 2 * N, (M,), generator=gen, device="cuda",
                            dtype=torch.int32)
        k1[what] = (acc, amt, 15, 2)
    k2 = {what: torch.randint(-128, 128, (J, C, 2 * N), generator=gen,
                              device="cuda", dtype=torch.int8)
          for what, (J, C, N) in K2_SHAPES.items()}
    for name in libs:
        if name in VARIANTS and name != "kernel":
            continue
        K._lib = libs[name]
        for what, a in k1.items():
            if not all(torch.equal(g, w) for g, w in zip(
                    K.rotate_decompose(*a), K.rotate_decompose_plain(*a))):
                raise AssertionError(f"{name}: K1 {what} differs")
        for what, dbl in k2.items():
            if not torch.equal(K.build_bigd_strips(dbl, True),
                               K.build_bigd_strips_plain(dbl, True)):
                raise AssertionError(f"{name}: K2 {what} differs")
    names = list(libs)
    for name in names + names[::-1]:
        K._lib = libs[name]
        print(f"{name:>15}: K1 " + ", ".join(
            f"{what} {cuda_ms(lambda: K.rotate_decompose(*a)):.4f} ms"
            for what, a in k1.items()) + "; K2 " + ", ".join(
            f"{what} {cuda_ms(lambda: K.build_bigd_strips(d, True)):.4f} ms"
            for what, d in k2.items()), flush=True)
    outs = [o for a in k1.values() for o in K.rotate_decompose(*a)]
    outs += [K.build_bigd_strips(d, True) for d in k2.values()]
    names = [f"K1 {w} out{i}" for w in k1 for i in range(2)] + [
        f"K2 {w}" for w in k2]
    print("zero_() of the output: " + ", ".join(
        f"{n} {cuda_ms(lambda: o.zero_()):.4f} ms"
        for n, o in zip(names, outs)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
