#!/usr/bin/env python3
"""What bounds K3 (``csrc/fused_external.cu``) on the card.

    python3 dct_cryptonets_tpu_torch/tools/k3_bound.py

Builds the kernel library three times from the committed sources: as it
stands, without its TMA loads (the producer only signals each stage, so
the tensor cores run on stale shared memory: the math alone) and without
its wgmma (the loads alone), then times one K3 call of each at the smoke's
phase-2 shapes (main: J=2, N=2048, rows=4, M=2048; aux: J=3, N=512,
rows=6, M=4096; drop 0), in turns, with CUDA events.  Only the kernel as
it stands is checked against the plain version; the variants compute
garbage by design.  Needs one NVIDIA GPU and nvcc.
"""
import os
import shutil
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from dct_cryptonets_tpu_torch.fhe import kernels as K  # noqa: E402

LOADS = """            mbar_expect_tx(&full[slot], t < 0 ? BOX_BYTES : TL::STAGE_BYTES);
            if (t >= 0) tma_load_3d(st, map_a, &full[slot], t * BK, m0, r);
            tma_load_2d(st + TL::A_BYTES, &map_b, &full[slot], col0 + t * BK,
                        brow);"""
NO_LOADS = ("            mbar_arrive(&full[slot]);\n"
            "            (void)st; (void)map_a; (void)brow;")
MMA = ("                wgmma_s8(d + 64 * mw, da + 512 * mw + 2 * kk, "
       "db + 2 * kk);")
NO_MMA = "                (void)da; (void)db;"
VARIANTS = {"kernel": [], "math only": [(LOADS, NO_LOADS)],
            "loads only": [(MMA, NO_MMA)]}
SHAPES = {"main": (2, 2048, 4, 2048), "aux": (3, 512, 6, 4096)}
BUILD = os.path.join(ROOT, "build", "k3_bound")


def build(name, edits):
    """The kernel library with K3's source edited; returns its ctypes
    handle (the wrappers launch whatever ``K._lib`` holds)."""
    src = os.path.join(BUILD, name.replace(" ", "_"), "csrc")
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(K.CSRC_DIR, src)
    path = os.path.join(src, "fused_external.cu")
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


def cuda_ms(fn, reps=10):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main():
    if not torch.cuda.is_available():
        print("k3_bound: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip() or "nvidia-smi unavailable", flush=True)
    csrc = K.CSRC_DIR
    libs = {}
    for name, edits in VARIANTS.items():
        K.CSRC_DIR = csrc
        libs[name] = build(name, edits)
    gen = torch.Generator(device="cuda").manual_seed(7)
    cases = {}
    for lat, (J, N, rows, M) in SHAPES.items():
        dbl = torch.randint(-128, 128, (J, 8 * rows, 2 * N), generator=gen,
                            device="cuda", dtype=torch.int8)
        acc = torch.randint(-2 ** 63, 2 ** 63 - 1, (J, M, N), generator=gen,
                            device="cuda", dtype=torch.int64)
        d0 = torch.randint(-128, 128, (rows, M, N), generator=gen,
                           device="cuda", dtype=torch.int8)
        d1 = torch.randint(-64, 65, (rows, M, N), generator=gen,
                           device="cuda", dtype=torch.int8)
        cases[lat] = (d0, d1, K.build_bigd_strips_plain(dbl, k_major=True),
                      acc, 0, 0)
    K._lib = libs["kernel"]
    for lat, args in cases.items():
        if not torch.equal(K.fused_external(*args),
                           K.fused_external_plain(*args)):
            raise AssertionError(f"K3 {lat} differs from its plain version")
    names = list(VARIANTS)
    for name in names + names[::-1]:
        K._lib = libs[name]
        print(f"{name:>10}: " + ", ".join(
            f"{lat} {cuda_ms(lambda: K.fused_external(*args)):.3f} ms"
            for lat, args in cases.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
