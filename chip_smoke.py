#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dct_cryptonets_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printed with its elapsed seconds; any failure exits nonzero:
  0. device: require CUDA, print the card's name and power limit, turn TF32
     off for matmuls and cuDNN;
  1. build the CMUX kernels (K1-K5) from csrc/ with nvcc for sm_90a, one
     nvcc per source, all started together, and beside them the native
     host codec (native/dctcodec.cpp) with g++ into build/native/;
  2. each kernel against its plain PyTorch version, bit for bit, at the
     main (preset 6, N=2048) and extraction (k2n512f, N=512) lattices (K1
     and K2 in both layouts, K2 at drop 0, 1, 2 and 4, K3 at every (drop,
     cross) with drop in {0, 1, 2, 4} and ragged M), each timed beside its
     bound (bytes over 3.35 TB/s or int8 operations over 1,979 TOPS) and
     beside the library call that computes the same function where there
     is one (K2: one advanced-index gather; K3: the s2d engine's two int8
     GEMMs at the same M and drop); K1 on the main lattice also at M=4096,
     the image's batch; K2 and K3 also at the production M at every knob
     the noise audit picks for the image (AUDIT_KNOBS);
  3. the flagship ResNet20qat checkpoint compiled with calibration through
     the port's eval flow, keygen for preset 6 and k2n512f, then one
     production PBS batch under those keys: bootstrap and clear_low_bits on
     256 ciphertexts with the kernel engine, equal to the plain engine and
     decrypting to the table / cleared value;
  4. the s2d engine under the same keys: bootstrap and clear_low_bits equal
     to the kernel engine (and to s2d_plain at 256 ciphertexts), one
     production chunk of 4096 on each lattice timed against the kernel
     engine, K1 and K4 launched once per CMUX step and K2/K3 not at all,
     and one CMUX step of each engine timed on each lattice; then one
     torch.profiler pass over one production chunk of each lattice on the
     kernel engine: each kernel's device time as a share of the window,
     and the device's idle share; then, at the noise audit's knobs, the
     kernel engine equal to the s2d engine on one production bootstrap
     chunk at (drop 2, cross 1) and one 2-bit clear_low_bits chunk at the
     extraction knob (2, 1) with truncated keyswitches (5, 3) and keep_low 1;
  5. the slice: one synthetic image through forward(fhe="execute") on the
     mesh path (shard_over(data_mesh(1)): one entry on the card, sharing
     the module's keys) and forward(fhe="simulate"), same class, K1-K3
     launched;
  6. the audited slice: the same image under drop_policy="audit" (p_error
     0.01, phase 3's keys) through forward(fhe="execute", drop_limbs=0,
     check_ref=True), as the driver's --drop_policy audit runs it: the
     extraction lattice at the audit's knob and truncated keyswitches, the
     main bootstraps with every key limb (the audit's main knobs realize
     more slips than p_error on this image: tools/audit_image.py, PERF.md);
     the audit's summary and knobs, the realized TLU slips per layer
     (failing above p_error), the class from execute, simulate and the
     clear model, K1-K3 launched;
  7. train on the card: one Adam step of ResNet20qat (24 ch x 16^2, batch
     128 of the digits, augmentation off) on the CPU and on CUDA from the
     same init, held to each other in float64 (1e-9) and in float32
     (within 4x the CPU's own float32-vs-float64 distance), the float32
     CUDA step run with cuDNN's TF32 flag on and failing if any backward
     convolution runs with it on; the flagship recipe's first 3 epochs
     twice through ``train.main_impl`` from one seed (deterministic
     algorithms, as the trainer runs on the card), failing unless the two
     runs' weights, BN state and optimizer state are bit-equal; the
     flagship recipe (digits, --train_aug, batch 128, Adam 1e-3, 30
     epochs: 300 steps; fails under 85 % best val top-1), its steps per
     s printed; the new
     checkpoint and the committed flagship compiled through
     homomorphic_eval.prepare (QAT, calibration on 64 digits, exact
     rounding, n_bits 5, threshold 6) with clear and simulate top-1 over
     the CLI's 359 digits test images (fails when simulate is more than 5
     points under clear); one PTQ
     (ResNet20) and one random-init (ResNet20qat) compile through the
     same flow, each simulated on 4 images.  No CMUX kernel runs here;
  8. datasets, transforms, native codec (the data layer; no CMUX kernel
     runs here): a CIFAR-10 fixture at full size in the python-pickle
     layout (50,000 + 10,000 class-structured images from a seed, under
     build/phase8_cifar/); ``train.main`` on it at the flagship's preset
     for one epoch (351 steps; fails under 30 % best val top-1, chance is
     10 %); ``homomorphic_eval.prepare`` on it with the committed flagship
     (clear and simulate top-1 over 64 test images; the clear model's
     classes on CUDA equal to the CPU's on 8) and one ``homomorphic_eval``
     run under ``--profile_dir``, whose trace must hold a CUDA kernel
     event; the native host codec (built in phase 1) against the card's
     ``dct_from_pixels`` at the CIFAR preset (fs 4, S 16, 24 ch) and the
     ResNet18 preset (fs 8, S 56, 64 ch on 448-pixel crops), each with its
     images per s; every deterministic transform on CUDA against the CPU on
     the same draws (128 x 32^2 and 16 x 448^2), and one composed
     augmentation timed on 128 x 224^2; and, where Pillow is installed, an
     Imagenette folder fixture (10 classes of 500 x 375 PNGs) through a
     few ``train.main`` steps of ResNet18qat at the ResNet18 preset;
  9. the sharded paths: a. phase 5's image ran on the mesh path; phase 3's
     server keys, one production chunk per lattice, a training batch and
     a ResNet18-preset image go under build/phase9/ with their one-process
     results; then two processes on the one card (``parallel.initialize``,
     gloo, both on cuda:0): b. rank 0 loads the keys and ``shard_over``
     broadcasts them; each rank bootstraps its 2,048 of the 4,096-
     ciphertext preset-6 chunk and clears 2 bits of its half of the
     extraction chunk at the audit's knob (2, 1) with keyswitch drops
     (5, 3); the gathered outputs equal the one-process ones bit for bit,
     K1-K3 launched on each rank; c. one float64 Adam step of the
     flagship recipe (batch 128 as 64 + 64, augmentation on) within 1e-9
     of the one-process step; d. ``dct_ingest_sharded`` at the ResNet18
     preset (fs 8, S 56, 64 ch, one 448-pixel image) over the two
     processes and over a 4-entry one-card mesh, equal to ``dct_ingest``
     bit for bit.  Each part is timed; the ranks are joined with a
     timeout and a failure in either fails the phase;
 10. the precomputed strip table: under the default 2 GiB gate phase 3's
     keygen built none, nor would one at the audit's aux drop 2 (6.34
     GB); with the gate raised through ``max_bytes`` the table is built
     at aux (2, 1) (one K2 launch over all 1,536 key rows, timed and
     sized), the whole table equal to K2's plain version on the same key
     bytes and its entries to the steps' own strips, and one
     4096-ciphertext ``clear_low_bits`` chunk at (2, 1) with keyswitch
     drops (5, 3) and keep_low 1 fed from it, equal to the per-step chunk
     bit for bit, both timed in turns; K2 over the whole table and K3 on
     a table slice timed beside their bounds; then the table is freed;
 11. the larger lattices and ResNet-18: a. every kernel against its plain
     version at N=4096 and N=8192 (the main lattices of presets 7 and 8,
     k=1): K1 in both layouts, K5 and K4 at M in {64, 129, 2048, 4097},
     K2 at drops 0, 2 and 4 in both layouts, K3 at every M and (drop,
     cross) in {(0,0), (2,1), (3,0), (4,1), (7,0)}; each timed at M=2048
     beside its bound, K3 at (0,0) and (2,1) beside the library's two
     int8 GEMMs; b. one 64-ciphertext bootstrap chunk at preset 7 and one
     at preset 8 on random key bytes, kernel engine equal to the plain
     engine bit for bit, K1-K3 launched once per CMUX step; c. ResNet18qat
     at the reference's ImageNet row (DCT 64 ch x 56^2, filter 8,
     bit_width 5, rounding 7), drawn from seed 0 and calibrated on 64
     synthetic images on the card: the compile picks preset 7 (N=4096),
     and simulate on 2 images on the card equals the CPU's bit for bit.

The second-to-last line is the kernels' JSON record, the last line the
device record.
"""
import importlib.util
import json
import os
import pickle
import subprocess
import sys
import time

# phase 7's deterministic training needs cuBLAS's fixed workspace
# configuration; PyTorch sizes the workspace at the process's first cuBLAS
# call (phase 2's), so it is set before torch is imported
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from benchmark import common  # noqa: E402
from dct_cryptonets_tpu_torch.fhe import kernels as K  # noqa: E402
from dct_cryptonets_tpu_torch.fhe import torus as T  # noqa: E402

KERNELS = {
    "rotate_decompose": ("dct_cryptonets_tpu_torch/csrc/rotate_decompose.cu",
                         "dct_cryptonets_tpu/fhe/pallas_kernels.py:164"),
    "build_bigd_strips": ("dct_cryptonets_tpu_torch/csrc/bigd_strips.cu",
                          "dct_cryptonets_tpu/fhe/pallas_kernels.py:350"),
    "fused_external": ("dct_cryptonets_tpu_torch/csrc/fused_external.cu",
                       "dct_cryptonets_tpu/fhe/pallas_kernels.py:465"),
    "combine_accumulate": (
        "dct_cryptonets_tpu_torch/csrc/combine_accumulate.cu",
        "dct_cryptonets_tpu/fhe/pallas_kernels.py:273"),
    "rotate_diff": ("dct_cryptonets_tpu_torch/csrc/rotate_diff.cu",
                    "dct_cryptonets_tpu/fhe/pallas_kernels.py:530"),
}
# the kernels the flagship image's (kernel engine) path launches
FUSED_KERNELS = ("rotate_decompose", "build_bigd_strips", "fused_external")
# (J, N, rows, production batch) of the flagship's main and extraction
# lattices (phase 2) and of the main lattices of presets 7 and 8 (phase 11)
LATTICES = {"main": (2, 2048, 4, 2048), "aux": (3, 512, 6, 4096),
            "p7": (2, 4096, 4, 2048), "p8": (2, 8192, 4, 2048)}
# the (drop, cross) knobs the noise audit picks for the flagship image at
# p_error 0.01 on each lattice (phase 6 prints them and runs the aux one;
# tools/audit_image.py runs the main ones)
AUDIT_KNOBS = {"main": ((1, 1), (2, 0), (2, 1), (4, 1)), "aux": ((2, 1),)}
P_ERROR = 0.01
IMAGE_M = 4096                  # the CLI's --pbs_batch and aux batch
# the H100 SXM's peaks (NVIDIA's data sheet): HBM bytes/s, dense int8 ops/s
HBM_BPS, INT8_OPS = 3.35e12, 1979e12
SPIN_CYCLES = 4_000_000         # about 2 ms of the card's clock (cuda_ms)


def bound(name, J, N, rows, M, drop=0, cross=0, steps=1):
    """(bound_ms, bound_by) of one call at phase 2's shapes: each input
    read once, each output written once, over the HBM rate; for K3 also
    its int8 operations over the tensor-core peak.  At a (drop, cross)
    knob the strips hold L = 8 - drop key limbs and K3 runs the kept
    (digit byte, key limb) pairs only.  K2 builds the strips of ``steps``
    CMUX steps at once (the precomputed table: every step's)."""
    L, lev = 8 - drop, rows // J
    ops = 0
    if name.startswith("rotate_decompose"):
        nbytes = 8 * J * M * N + 4 * M + 2 * J * lev * M * N
    elif name == "build_bigd_strips":
        nbytes = steps * J * L * rows * (2 * N + 128 * (2 * N - 128))
    elif name == "fused_external":
        pairs = sum(len(v) for v in K.bucket_pairs(L, drop, cross).values())
        ops = 2 * J * pairs * rows * M * N * N
        nbytes = (2 * rows * M * N + J * L * rows * 128 * (2 * N - 128)
                  + 16 * J * M * N)
    elif name == "combine_accumulate":
        nbytes = 2 * 4 * M * J * L * N + 16 * M * J * N
    elif name == "rotate_diff":
        nbytes = 16 * M * J * N + 4 * M
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / INT8_OPS * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


class Phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        print(f"== phase {self.name}", flush=True)
        self.t = time.time()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        print(f"== phase {self.name}: {time.time() - self.t:.1f} s",
              flush=True)
        return False


def cuda_ms(fn, reps=20):
    """Device milliseconds per call of fn, from CUDA events around reps
    calls.  A spin kernel holds the stream while the host queues them, so
    the host's launch costs (tens of microseconds a wrapper call) are not
    counted where the device is faster."""
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


def max_abs_err(got, want) -> int:
    if isinstance(got, tuple):
        return max(max_abs_err(g, w) for g, w in zip(got, want))
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def rand_i64(gen, shape, dev):
    return torch.randint(-2 ** 63, 2 ** 63 - 1, shape, generator=gen,
                         device=dev, dtype=torch.int64)


def knob_key(lat, drop, cross=None):
    return f"{lat} drop={drop}" + ("" if cross is None else f" cross={cross}")


def phase_kernels(dev, record):
    """Every kernel against its plain version at production shapes.
    record[name][key] gets (ms, plain_ms, library_ms or None, M, drop,
    cross); key is the lattice, with the batch or the knob where those
    differ from the lattice's production drop-0 call."""
    gen = torch.Generator(device=dev).manual_seed(1234)
    errs = {name: 0 for name in KERNELS}

    def check(name, got, want, what):
        err = max_abs_err(got, want)
        equal = all(torch.equal(g, w) for g, w in zip(
            got if isinstance(got, tuple) else (got,),
            want if isinstance(want, tuple) else (want,)))
        errs[name] = max(errs[name], err)
        print(f"  {name} {what}: {'equal' if equal else 'DIFFERENT'}"
              f" (max |err| {err})", flush=True)
        if not equal:
            raise AssertionError(f"{name} {what} differs from its plain "
                                 "version")

    for lat in ("main", "aux"):
        J, N, rows, Mprod = LATTICES[lat]

        def tops(M, ms, drop, cross, J=J, N=N, rows=rows):
            """int8 tensor ops per second of K3's kept pairs (2 per
            multiply-add)."""
            pairs = sum(len(v) for v in K.bucket_pairs(
                8 - drop, drop, cross).values())
            return 2 * J * pairs * rows * M * N * N / ms / 1e9

        # the image runs K1 at M=4096 on both lattices
        for M in (13, 256, Mprod) + ((IMAGE_M,) if Mprod < IMAGE_M else ()):
            acc = rand_i64(gen, (J, M, N), dev)
            amt = torch.randint(0, 2 * N, (M,), generator=gen, device=dev,
                                dtype=torch.int32)
            amt[:3] = torch.tensor([0, N, 2 * N - 1], device=dev)
            args = (acc, amt, 15, 2)
            check("rotate_decompose", K.rotate_decompose(*args),
                  K.rotate_decompose_plain(*args), f"{lat} M={M}")
            if M in (Mprod, IMAGE_M):
                record["rotate_decompose"][
                    lat if M == Mprod else f"{lat} M={M}"] = (
                    cuda_ms(lambda: K.rotate_decompose(*args)),
                    cuda_ms(lambda: K.rotate_decompose_plain(*args)), None,
                    M, 0, 0)
            if M != Mprod and M == IMAGE_M:
                continue
            # the s2d engine's layout: a sample-major (M, J, N) accumulator
            sm = acc.transpose(0, 1).contiguous()
            check("rotate_decompose",
                  K.rotate_decompose(sm, amt, 15, 2, plane_major=False),
                  K.rotate_decompose_plain(sm, amt, 15, 2, plane_major=False),
                  f"{lat} sample-major M={M}")
            check("rotate_diff", K.rotate_diff(sm, amt),
                  K.rotate_diff_plain(sm, amt), f"{lat} M={M}")
            if M == Mprod:
                record["rotate_decompose sample-major"][lat] = (
                    cuda_ms(lambda: K.rotate_decompose(
                        sm, amt, 15, 2, plane_major=False)),
                    cuda_ms(lambda: K.rotate_decompose_plain(
                        sm, amt, 15, 2, plane_major=False)), None, M, 0, 0)
                record["rotate_diff"][lat] = (
                    cuda_ms(lambda: K.rotate_diff(sm, amt)),
                    cuda_ms(lambda: K.rotate_diff_plain(sm, amt)), None, M,
                    0, 0)
        # K4 on full-range int32 terms, so the int32 bucket sums wrap
        for drop, cross in ((0, 0), (2, 0), (0, 1), (2, 1)):
            for M in (13, 256) + ((Mprod,) if drop == cross == 0 else ()):
                acc = rand_i64(gen, (M, J, N), dev)
                o0, o1 = (torch.randint(
                    -2 ** 31, 2 ** 31 - 1, (M, J * (8 - drop), N),
                    generator=gen, device=dev, dtype=torch.int32)
                    for _ in range(2))
                args = (o0, o1, acc, drop, cross)
                check("combine_accumulate", K.combine_accumulate(*args),
                      K.combine_accumulate_plain(*args),
                      f"{lat} drop={drop} cross={cross} M={M}")
                if M == Mprod:
                    record["combine_accumulate"][lat] = (
                        cuda_ms(lambda: K.combine_accumulate(*args)),
                        cuda_ms(lambda: K.combine_accumulate_plain(*args)),
                        None, M, 0, 0)
            del o0, o1
        knobs = AUDIT_KNOBS[lat]
        for drop in (0, 1, 2, 4):
            C = (8 - drop) * rows
            dbl = torch.randint(-128, 128, (J, C, 2 * N), generator=gen,
                                device=dev, dtype=torch.int8)
            for km in (False, True):
                check("build_bigd_strips", K.build_bigd_strips(dbl, km),
                      K.build_bigd_strips_plain(dbl, km),
                      f"{lat} drop={drop} k_major={km}")
            if drop == 0 or any(d == drop for d, _ in knobs):
                # the library: one gather with the index built beforehand
                idx = (-K._strip_index(N, dev)) % (2 * N)
                record["build_bigd_strips"][
                    lat if drop == 0 else knob_key(lat, drop)] = (
                    cuda_ms(lambda: K.build_bigd_strips(dbl, True)),
                    cuda_ms(lambda: K.build_bigd_strips_plain(dbl, True)),
                    cuda_ms(lambda: dbl[:, :, idx]), Mprod, drop, 0)
            strips = K.build_bigd_strips(dbl, k_major=True)
            for cross in (0, 1):
                timed_here = drop == cross == 0 or (drop, cross) in knobs
                for M in (13, 256) + ((Mprod,) if timed_here else ()):
                    acc = rand_i64(gen, (J, M, N), dev)
                    d0 = torch.randint(-128, 128, (rows, M, N), generator=gen,
                                       device=dev, dtype=torch.int8)
                    d1 = torch.randint(-64, 65, (rows, M, N), generator=gen,
                                       device=dev, dtype=torch.int8)
                    args = (d0, d1, strips, acc, drop, cross)
                    check("fused_external", K.fused_external(*args),
                          K.fused_external_plain(*args),
                          f"{lat} drop={drop} cross={cross} M={M}")
                    if M == Mprod:
                        ms = cuda_ms(lambda: K.fused_external(*args))
                        plain = cuda_ms(lambda: K.fused_external_plain(*args),
                                        reps=2)
                        lib = library_ms(J, N, rows, M, drop)
                        key = lat if drop == cross == 0 else knob_key(
                            lat, drop, cross)
                        record["fused_external"][key] = (ms, plain, lib, M,
                                                         drop, cross)
                        print(f"  fused_external {key} M={M}: {ms:.3f} ms "
                              f"kernel ({tops(M, ms, drop, cross):.1f} "
                              f"TOPS), {plain:.3f} ms plain, {lib:.3f} ms "
                              "library (two int8 GEMMs)", flush=True)
    for name, per in record.items():
        for lat in per:
            print_timing(record, name, lat)
    return errs


def print_timing(record, name, lat):
    ms, plain, lib, M, drop, cross, *steps = record[name][lat]
    J, N, rows, _ = LATTICES[lat.split()[0]]
    b, by = bound(name, J, N, rows, M, drop, cross, *steps)
    print(f"  time {name} {lat}: kernel {ms:.4f} ms, plain {plain:.3f} ms, "
          "library " + ("-" if lib is None else f"{lib:.4f} ms")
          + f", bound {b:.4f} ms ({by}), {100 * b / ms:.1f} % of bound",
          flush=True)


def library_ms(J, N, rows, M, drop=0):
    """The same products as K3 from the library: the s2d engine's two int8
    GEMMs (``torch._int_mm``) on its operand of random key bytes at the
    same drop.  They run every (digit byte, kept key limb) pair: at drop 0
    one pair more than K3 (it wraps out of 2^64), and at a knob also the
    pairs K3 skips."""
    from dct_cryptonets_tpu_torch.fhe import pbs as P
    from dct_cryptonets_tpu_torch.fhe.intmm import int8_matmul

    gen = torch.Generator(device="cuda").manual_seed(M)
    bsk = torch.randint(-128, 128, (rows, J, 2 * N, 8), generator=gen,
                        device="cuda", dtype=torch.int8)
    kern = P.expand_bsk_kernel_s2d(bsk, J - 1, rows // J, N, drop)
    d0, d1 = (torch.randint(-128, 128, (M, rows * N), generator=gen,
                            device="cuda", dtype=torch.int8)
              for _ in range(2))
    return cuda_ms(lambda: (int8_matmul(d0, kern), int8_matmul(d1, kern)))


CKPT = os.path.join(ROOT, "checkpoints", "digits_flagship", "best.tar")


def prepare_slice(dev):
    """The flagship module through the port's eval flow: checkpoint ->
    calibrated compile on synthetic data -> keygen (preset 6 and k2n512f,
    from seed 0)."""
    from dct_cryptonets_tpu_torch import homomorphic_eval as HE

    cfg = HE.parse_args("homomorphic_eval", [
        "--dataset", "synthetic", "--dct_status", "--model", "ResNet20qat",
        "--channels", "24", "--filter_size", "4", "--image_size_dct", "16",
        "--bit_width", "4", "--n_bits", "5", "--rounding_threshold_bits", "6",
        "--rounding_method", "exact", "--residual_mode", "fused",
        "--range_margin", "1.0", "--drop_policy", "none",
        "--checkpoint_path", CKPT, "--fhe_mode", "execute",
        "--test_subset", "1"])
    t = time.time()
    s = HE.prepare(cfg, dev)
    m = s.module
    print(f"  load + calibrated compile: {time.time() - t:.1f} s; "
          f"{m.circuit.num_pbs} PBS per image, max bit-width "
          f"{m.maximum_integer_bit_width()}", flush=True)
    m.keygen(seed=0)
    aux = m.exact_cfg.aux
    print(f"  keygen: {m.stats['keygen_time']:.1f} s\n  main {m.params}\n"
          f"  aux {aux}", flush=True)
    if ((m.params.lwe_dim, m.params.glwe_dim, m.params.poly_size) != (
            776, 1, 2048) or (aux.lwe_dim, aux.glwe_dim, aux.poly_size) != (
            512, 2, 512)):
        raise AssertionError("expected preset 6 and k2n512f")
    return s


def phase_pbs(m, dev):
    """Bootstrap and clear_low_bits on 256 random ciphertexts under the
    module's keys: kernel engine == plain engine, bit for bit, and the
    outputs decrypt to the table / the cleared value."""
    from scipy.stats import binom

    from dct_cryptonets_tpu_torch.fhe import (NoiseModel, decrypt_lwe,
                                              encrypt_lwe)
    from dct_cryptonets_tpu_torch.fhe import pbs as P

    par, cfg = m.params, m.exact_cfg
    ck, dsk, dak = m.client_keys, m.device_keys, m.aux_keys
    rng = np.random.default_rng(14)
    M, r, out_log2 = 256, 6, 51

    def phase_of(ct):
        return decrypt_lwe(ck, T.to_u64(ct), key=ck.big_lwe_key)

    def both(fn, what):
        outs = {}
        for engine in ("kernel", "plain"):
            torch.cuda.synchronize()
            t = time.time()
            outs[engine] = fn(engine)
            torch.cuda.synchronize()
            print(f"  {what} engine={engine}: {time.time() - t:.2f} s",
                  flush=True)
        if not torch.equal(outs["kernel"], outs["plain"]):
            raise AssertionError(f"{what}: kernel engine != plain engine")
        print(f"  {what}: kernel engine == plain engine (bit for bit)",
              flush=True)
        return outs["kernel"]

    # bootstrap: 6-bit index u, random signed 13-bit tables, output at 2^51
    msgs = rng.integers(0, 2 ** r, M)
    ct = T.from_u64(encrypt_lwe(
        ck, msgs.astype(np.uint64) << np.uint64(64 - r - 1), rng,
        key=ck.big_lwe_key, noise_log2=par.glwe_noise_log2), dev)
    tables = torch.as_tensor(rng.integers(-2 ** 11, 2 ** 11, (M, 2 ** r)),
                             dtype=torch.int32, device=dev)
    out = both(lambda e: P.bootstrap(ct, tables, dsk, par, out_log2,
                                     engine=e), f"bootstrap M={M}")
    dec = np.round(phase_of(out).astype(np.int64).astype(np.float64)
                   / 2.0 ** out_log2).astype(np.int64)
    tab = tables.cpu().numpy().astype(np.int64)
    rows = np.arange(M)
    bad = dec != tab[rows, msgs]
    # preset 6 runs 6-bit tables at a per-PBS error probability of about
    # 1% by design: a slip reads a neighbouring window (negacyclic at the
    # ends), and the count stays inside the noise model's 1e-6 tail
    up = np.where(msgs == 2 ** r - 1, -tab[:, 0], tab[rows, (msgs + 1) % 2 ** r])
    down = np.where(msgs == 0, -tab[:, -1], tab[rows, msgs - 1])
    gross = bad & (dec != up) & (dec != down)
    p_slip = NoiseModel(par).pbs_error_probability(r, NoiseModel(
        par).var_fresh_glwe())
    limit = int(binom.isf(1e-6, M, p_slip))
    print(f"  bootstrap decrypts to the table: {M - int(bad.sum())}/{M} "
          f"(neighbour-window slips allowed: {limit}, modeled p "
          f"{p_slip:.4f}; other errors {int(gross.sum())})", flush=True)
    if gross.any() or bad.sum() > limit:
        raise AssertionError(f"bootstrap: {int(bad.sum())}/{M} outputs "
                             f"decrypt wrong, {int(gross.sum())} gross")

    # clear_low_bits: the low 2 bits of a 10-bit value, one aux bootstrap
    # per bit
    n_in, shift = 10, 2
    v = rng.integers(0, 1 << n_in, M)
    ct = T.from_u64(encrypt_lwe(
        ck, v.astype(np.uint64) << np.uint64(63 - n_in), rng,
        key=ck.big_lwe_key, noise_log2=par.glwe_noise_log2), dev)
    out = both(lambda e: P.clear_low_bits(
        ct, dak, cfg.aux, n_in, shift, cfg.back_base_log, cfg.back_levels,
        engine=e), f"clear_low_bits M={M} shift={shift}")
    dec = np.round(phase_of(out).astype(np.float64)
                   / 2.0 ** (63 - n_in)).astype(np.int64) % (1 << (n_in + 1))
    want = v - v % (1 << shift)
    bad = int(np.count_nonzero(dec != want))
    print(f"  clear_low_bits decrypts to the cleared value: {M - bad}/{M}",
          flush=True)
    if bad:
        raise AssertionError(f"clear_low_bits: {bad}/{M} outputs wrong")


def cmux_step_ms(par, bsk_bytes, M, dev):
    """One CMUX step of each engine on random accumulators under step 0 of
    the module's key, timed with CUDA events: the fused engine (strips, K1,
    K3) and the s2d engine (operand, K1 sample-major, two int8 GEMMs, K4),
    with the s2d step's parts.  The two steps must agree bit for bit."""
    from dct_cryptonets_tpu_torch.fhe import pbs as P

    k, N, levels, blog = (par.glwe_dim, par.poly_size, par.pbs_levels,
                          par.pbs_base_log)
    gen = torch.Generator(device=dev).manual_seed(N)
    acc = rand_i64(gen, (k + 1, M, N), dev)
    amt = torch.randint(0, 2 * N, (M,), generator=gen, device=dev,
                        dtype=torch.int32)
    sm = acc.transpose(0, 1).contiguous()
    bsk_i, pt = bsk_bytes[0], (blog, levels, k, N)

    def fused():
        strips = K.build_bigd_strips(P._bigd_rows(bsk_i, k, levels, N, 0),
                                     k_major=True)
        d0, d1 = K.rotate_decompose(acc, amt, blog, levels)
        return K.fused_external(d0, d1, strips, acc, 0)

    def operand():
        return P.expand_bsk_kernel_s2d(bsk_i, k, levels, N, 0)

    def s2d():
        return P.cmux_accumulate_s2d(sm, amt, operand(), pt, 0, engine="s2d")

    if not torch.equal(fused().transpose(0, 1), s2d()):
        raise AssertionError(f"N={N}: s2d CMUX step != fused CMUX step")
    kern = operand()
    d0, d1 = K.rotate_decompose(sm, amt, blog, levels, plane_major=False)
    o0 = P.conv_external_s2d(d0, kern, k, N, 0)
    o1 = P.conv_external_s2d(d1, kern, k, N, 0)
    out = {"fused step": cuda_ms(fused), "s2d step": cuda_ms(s2d),
           "s2d operand": cuda_ms(operand),
           "s2d K1": cuda_ms(lambda: K.rotate_decompose(
               sm, amt, blog, levels, plane_major=False)),
           "s2d GEMMs": cuda_ms(lambda: (
               P.conv_external_s2d(d0, kern, k, N, 0),
               P.conv_external_s2d(d1, kern, k, N, 0))),
           "s2d K4": cuda_ms(lambda: K.combine_accumulate(o0, o1, sm, 0))}
    rows, cols = kern.shape
    out["s2d GEMM TOPS"] = 2 * 2 * M * rows * cols / out["s2d GEMMs"] / 1e9
    return out


def phase_s2d(m, dev, card):
    """The s2d engine under the module's keys, against the kernel engine.
    Returns the launch counts of its two production-size path runs."""
    from dct_cryptonets_tpu_torch.fhe import encrypt_lwe
    from dct_cryptonets_tpu_torch.fhe import pbs as P

    par, cfg = m.params, m.exact_cfg
    ck, dsk, dak = m.client_keys, m.device_keys, m.aux_keys
    rng = np.random.default_rng(15)
    r, out_log2, n_in, shift = 6, 51, 10, 2
    Mprod = IMAGE_M
    launches = dict.fromkeys(KERNELS, 0)

    def fresh(M, msgs, delta_log2):
        return T.from_u64(encrypt_lwe(
            ck, msgs.astype(np.uint64) << np.uint64(delta_log2), rng,
            key=ck.big_lwe_key, noise_log2=par.glwe_noise_log2), dev)

    def run(what, fn, engines, n_steps=None):
        """fn(engine) on each engine, timed; all equal bit for bit.  With
        n_steps, the s2d run is a path run: counts reset just before it
        and read just after, K1/K4 once per CMUX step and K2/K3 never."""
        outs, secs = {}, {}
        for e in engines:
            if n_steps and e == "s2d":
                K.reset_launch_counts()
            outs[e], secs[e] = common.timed(lambda: fn(e), dev)
            if n_steps and e == "s2d":
                counts = K.launch_counts()
                want = dict.fromkeys(KERNELS, 0)
                want.update(rotate_decompose=n_steps,
                            combine_accumulate=n_steps)
                if counts != want:
                    raise AssertionError(f"{what}: s2d launches {counts}, "
                                         f"expected {want}")
                for name, n in counts.items():
                    launches[name] += n
        for e in engines[1:]:
            if not torch.equal(outs[e], outs[engines[0]]):
                raise AssertionError(f"{what}: engine {e} != "
                                     f"{engines[0]}")
        print(f"  {what}: " + " == ".join(engines) + " (bit for bit); "
              + ", ".join(f"{e} {secs[e]:.2f} s" for e in engines),
              flush=True)
        return secs

    three = ("s2d", "kernel", "s2d_plain")
    chunks = {}                       # the kernel engine's production chunks
    for M in (256, Mprod):
        ct = fresh(M, rng.integers(0, 2 ** r, M), 64 - r - 1)
        tables = torch.as_tensor(rng.integers(-2 ** 11, 2 ** 11, (M, 2 ** r)),
                                 dtype=torch.int32, device=dev)
        boot = run(f"bootstrap preset 6 M={M}", lambda e: P.bootstrap(
            ct, tables, dsk, par, out_log2, engine=e),
            three if M == 256 else three[:2],
            par.lwe_dim if M == Mprod else None)
        if M == Mprod:
            chunks["bootstrap preset 6"] = lambda ct=ct, tables=tables: \
                P.bootstrap(ct, tables, dsk, par, out_log2, engine="kernel")
        ct = fresh(M, rng.integers(0, 1 << n_in, M), 63 - n_in)
        if M == Mprod:
            chunks[f"clear_low_bits k2n512f ({shift} bits)"] = \
                lambda ct=ct: P.clear_low_bits(
                    ct, dak, cfg.aux, n_in, shift, cfg.back_base_log,
                    cfg.back_levels, engine="kernel")
        clear = run(f"clear_low_bits k2n512f M={M} shift={shift}",
                    lambda e: P.clear_low_bits(
                        ct, dak, cfg.aux, n_in, shift, cfg.back_base_log,
                        cfg.back_levels, engine=e),
                    three if M == 256 else three[:2],
                    shift * cfg.aux.lwe_dim if M == Mprod else None)
    # the audit's knobs: main (drop 2, cross 1); extraction (2, 1) with the
    # truncated keyswitches (5, 3), keeping the lowest bit
    ct = fresh(Mprod, rng.integers(0, 2 ** r, Mprod), 64 - r - 1)
    tables = torch.as_tensor(rng.integers(-2 ** 11, 2 ** 11, (Mprod, 2 ** r)),
                             dtype=torch.int32, device=dev)
    run(f"bootstrap preset 6 M={Mprod} drop=2 cross=1", lambda e: P.bootstrap(
        ct, tables, dsk, par, out_log2, 2, 1, engine=e), three[:2],
        par.lwe_dim)
    ct = fresh(Mprod, rng.integers(0, 1 << n_in, Mprod), 63 - n_in)
    run(f"clear_low_bits k2n512f M={Mprod} shift={shift} keep_low=1 drop=2 "
        "cross=1 ks_drop=5/3", lambda e: P.clear_low_bits(
            ct, dak, cfg.aux, n_in, shift, cfg.back_base_log,
            cfg.back_levels, 2, 1, 5, 3, 1, engine=e), three[:2],
        (shift - 1) * cfg.aux.lwe_dim)
    print(f"  [{card}] production chunk, M={Mprod}: bootstrap preset 6 "
          f"s2d {boot['s2d']:.2f} s, kernel {boot['kernel']:.2f} s; "
          f"clear_low_bits k2n512f ({shift} bits) s2d {clear['s2d']:.2f} s, "
          f"kernel {clear['kernel']:.2f} s", flush=True)
    for lat, p, bsk in (("main", par, dsk.bsk_bytes),
                        ("aux", cfg.aux, dak.bsk_bytes)):
        t = cmux_step_ms(p, bsk, Mprod, dev)
        print(f"  [{card}] CMUX step {lat} M={Mprod}: " + ", ".join(
            f"{k} {v:.3f}" + ("" if "TOPS" in k else " ms")
            for k, v in t.items()), flush=True)
    for what, fn in chunks.items():
        profile_chunk(fn, f"{what} M={Mprod}", card)
    return launches


def profile_chunk(fn, what, card):
    """One run of fn under torch.profiler (``benchmark.common``): each
    kernel's device time as a share of the window and the device's idle
    share, printed."""
    prof = common.profile_chunk(fn)
    print(f"  [{card}] profile {what}: window {prof['window_ms']:.1f} ms "
          f"(host {prof['host_s']:.2f} s with the profiler on), device idle "
          f"{100 * prof['idle_share']:.2f} %; " + ", ".join(
              f"{k} {100 * v:.2f} %"
              for k, v in list(prof["kernel_shares"].items())[:8]),
          flush=True)


def phase_slice(s, dev):
    """One synthetic test image through forward(fhe="execute") on the mesh
    path (``shard_over(data_mesh(1))``: one entry on the card, sharing the
    module's keys, so no key is copied) and forward(fhe="simulate").
    Returns the kernels' launch counts of the execute run and its
    seconds."""
    from dct_cryptonets_tpu_torch.fhe import Csprng
    from dct_cryptonets_tpu_torch.parallel import data_mesh

    m = s.module
    images, labels = s.testset.gather(s.test_idx[:1])
    x = s.ingest(images).cpu().numpy()
    mesh = data_mesh(1)
    m.shard_over(mesh)
    shared = all(a is b for a, b in zip(m.replicas[1][0][0], m.device_keys))
    print(f"  mesh path: {mesh.size} entry on {mesh.devices[0]}, keys shared "
          f"with the module: {shared}", flush=True)
    if not shared:
        raise AssertionError("a one-entry mesh on the module's card copied "
                             "its keys")
    K.reset_launch_counts()
    t = time.time()
    feats = m.forward(x, fhe="execute", mesh=mesh, enc_rng=Csprng(5))
    secs = time.time() - t
    launches = K.launch_counts()
    sim = m.forward(x, fhe="simulate")
    st = m.stats
    print(f"  launches in the execute run: {launches}", flush=True)
    print("  stats: " + json.dumps({k: st.get(k) for k in (
        "execute_time", "levelled_time", "pbs_time", "extract_time",
        "pbs_per_sec", "pbs_executed", "aux_pbs_executed", "keygen_time")}),
        flush=True)
    if feats.shape != sim.shape or not np.all(np.isfinite(feats)):
        raise AssertionError(f"bad features {feats.shape} vs {sim.shape}")
    clf_w = np.asarray(s.params["classifier"]["w"])
    clf_b = np.asarray(s.params["classifier"]["b"])
    cls_e = int(np.argmax(feats @ clf_w + clf_b))
    cls_s = int(np.argmax(sim @ clf_w + clf_b))
    with torch.no_grad():
        _, logits = s.model(torch.as_tensor(x, device=dev))
    n_diff = int(np.count_nonzero(feats != sim))
    print(f"  class: execute {cls_e}, simulate {cls_s}, clear QAT model "
          f"{int(logits.argmax())}, label {int(labels[0])}; features that "
          f"differ between execute and simulate: {n_diff}/{feats.size}",
          flush=True)
    if cls_e != cls_s:
        raise AssertionError("execute and simulate predict different classes")
    missing = [k for k in FUSED_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")
    return launches, secs


def phase_audited(s, dev, drop_limbs=0, enforce=True):
    """The phase-5 image under drop_policy="audit" with the realized-slip
    audit, on phase 3's keys and the extraction knobs keygen would set.

    drop_limbs=0 runs the main bootstraps with every key limb, as the
    driver's ``--drop_policy audit`` does (its ``--drop_limbs`` default):
    the audit picks the extraction lattice's knob, its truncated
    keyswitches and keep_low.  drop_limbs=None also runs the audit's
    per-layer main (drop, cross) knobs; on the flagship those realize more
    TLU slips than p_error (PERF.md), so only
    ``tools/audit_image.py`` runs them.  enforce: fail when the realized
    slips exceed p_error or K1-K3 were not launched.  Returns the kernels'
    launch counts of the execute run and the module."""
    from collections import Counter

    from dct_cryptonets_tpu_torch.fhe import Csprng
    from dct_cryptonets_tpu_torch.fhe.circuit import Tlu
    from dct_cryptonets_tpu_torch.fhe.runtime import CompiledModule

    m = s.module
    am = CompiledModule(
        m.circuit, m.params, client_keys=m.client_keys,
        device_keys=m.device_keys, pbs_batch=m.pbs_batch,
        aux_batch=m.aux_batch, rounding_method=m.rounding_method,
        exact_cfg=m.exact_cfg, aux_keys=m.aux_keys, drop_policy="audit",
        p_error=P_ERROR, device=dev)
    t = time.time()
    am.choose_aux_knobs()
    audit = am.run_audit()
    print(f"  audit: {time.time() - t:.2f} s\n" + audit.summary(), flush=True)
    hist = Counter()
    for r in audit.reports:
        hist[f"({r.drop_limbs},{r.cross})"] += r.sites
    keeps = Counter(r.keep_low for r in audit.reports)
    print(f"  main knobs, sites per (drop,cross): {dict(hist)}; keep_low "
          f"per layer: {dict(keeps)}; aux knob ({am.aux_drop_limbs},"
          f"{am.aux_cross}); keyswitch drops fwd {am.aux_fwd_ks_drop} back "
          f"{am.aux_back_ks_drop}; this run's main knobs: "
          + ("the audit's" if drop_limbs is None else f"drop {drop_limbs}"),
          flush=True)
    images, labels = s.testset.gather(s.test_idx[:1])
    x = s.ingest(images).cpu().numpy()
    K.reset_launch_counts()
    feats = am.forward(x, fhe="execute", drop_limbs=drop_limbs,
                       enc_rng=Csprng(5), check_ref=True)
    launches = K.launch_counts()
    sim = am.forward(x, fhe="simulate")
    st = am.stats
    print(f"  launches in the execute run: {launches}", flush=True)
    print("  stats: " + json.dumps({k: st.get(k) for k in (
        "execute_time", "levelled_time", "pbs_time", "extract_time",
        "pbs_per_sec", "pbs_executed", "aux_pbs_executed", "audit_time")}),
        flush=True)
    acc_of = {op.out: op.x for op in am.circuit.ops if isinstance(op, Tlu)}
    for wire, n_bad, n, n_gross, max_abs in st["tlu_slip_detail"]:
        p_tlu = audit.by_acc[acc_of[wire]].p_total
        print(f"  slips {wire}: {n_bad}/{n} (|d| > 1: {n_gross}, max |d| "
              f"{max_abs}; audited p {p_tlu:.2e})", flush=True)
    slips, sites = st["tlu_slips"], st["tlu_sites"]
    print(f"  realized TLU slips: {slips}/{sites} = {slips / sites:.5f} "
          f"(p_error {P_ERROR})", flush=True)
    if feats.shape != sim.shape or not np.all(np.isfinite(feats)):
        raise AssertionError(f"bad features {feats.shape} vs {sim.shape}")
    clf_w = np.asarray(s.params["classifier"]["w"])
    clf_b = np.asarray(s.params["classifier"]["b"])
    with torch.no_grad():
        _, logits = s.model(torch.as_tensor(x, device=dev))
    print(f"  class: execute {int(np.argmax(feats @ clf_w + clf_b))}, "
          f"simulate {int(np.argmax(sim @ clf_w + clf_b))}, clear QAT model "
          f"{int(logits.argmax())}, label {int(labels[0])}; features that "
          f"differ between execute and simulate: "
          f"{int(np.count_nonzero(feats != sim))}/{feats.size}", flush=True)
    if sites != m.circuit.num_pbs:
        raise AssertionError(f"slip audit saw {sites} of "
                             f"{m.circuit.num_pbs} TLU sites")
    if enforce and slips > P_ERROR * sites:
        raise AssertionError(f"realized slips {slips}/{sites} exceed "
                             f"p_error {P_ERROR}")
    missing = [k for k in FUSED_KERNELS if launches[k] == 0]
    if enforce and missing:
        raise AssertionError(f"kernels not launched on the audited path: "
                             f"{missing}")
    return launches, am


# the flagship training recipe (scripts/run_train.sh with --dataset digits
# --train_aug), the recipe of checkpoints/digits_flagship
TRAIN_ARGS = ["--dataset", "digits", "--dct_status", "--train_aug",
              "--model", "ResNet20qat", "--channels", "24", "--filter_size",
              "4", "--image_size_dct", "16", "--batch_size", "128",
              "--test_batch_size", "256", "--lr", "0.001", "--optimizer",
              "adam", "--stop_epoch", "30"]
SHORT_EPOCHS = 3                # the recipe's first epochs, run twice
MIN_VAL_TOP1 = 85.0             # chance is 10 %; the JAX log reached 94.4
MAX_SIM_DROP = 5.0              # points of simulate top-1 under clear
# the JAX package's counts on the committed flagship over the 359 digits
# test images (clear, simulate; ROUND5.md)
JAX_FLAGSHIP = (330, 322)


def train_steps(dev):
    """One Adam step of ResNet20qat (24 ch x 16^2) from the same calibrated
    init on the same digits batch of 128, augmentation off: in float64 on
    the CPU and on ``dev``, and in float32 on both.  The float32 step on
    ``dev`` runs with cuDNN's TF32 flag switched on, and a hook in every
    convolution's backward reads the flag as the step runs it.  Returns
    ({(dtype, device type): (loss, params, state, gradients)}, the flags
    the hooks read, the number of convolutions, the caller's flag after
    the step)."""
    from dct_cryptonets_tpu_torch import train as TRAIN
    from dct_cryptonets_tpu_torch.data import pipeline
    from dct_cryptonets_tpu_torch.data.codec import CodecConfig, dct_ingest
    from dct_cryptonets_tpu_torch.models.resnet import (
        QATResNet, _QConv, build_spec, calibrate_scales, init_model)

    spec = build_spec("ResNet20qat", in_channels=24, img_size=16)
    ds = pipeline.get_dataset("digits", None, True, image_size=64)
    x = dct_ingest(ds.images[:192], CodecConfig(24, 4, 16))
    y = torch.as_tensor(ds.labels[64:192].astype(np.int64))
    params, state = init_model(spec)
    params = calibrate_scales(params, state, x[:64], spec)
    cfg = TRAIN.parse_args("train", TRAIN_ARGS)
    out, seen, convs, flag_after = {}, [], 0, None
    cudnn = torch.backends.cudnn
    for dt in (torch.float64, torch.float32):
        for d in (torch.device("cpu"), dev):
            model = QATResNet.from_params(params, state, spec).to(d, dt)
            opt = TRAIN.make_optimizer(cfg, cfg.lr, model.parameters())
            hooked = dt == torch.float32 and d.type == "cuda"
            if hooked:
                for m in model.modules():
                    if isinstance(m, _QConv):
                        convs += 1
                        m.register_full_backward_hook(
                            lambda *_: seen.append(cudnn.allow_tf32))
            before = cudnn.allow_tf32
            cudnn.allow_tf32 = hooked or before
            try:
                loss, _ = TRAIN.train_step(model, opt, cfg,
                                           x[64:].to(d, dt), y.to(d),
                                           torch.Generator())
                if hooked:
                    flag_after = cudnn.allow_tf32
            finally:
                cudnn.allow_tf32 = before
            grads = [p.grad.cpu().numpy() for p in model.parameters()]
            out[dt, d.type] = (float(loss), *model.to_params(), grads)
    return out, seen, convs, flag_after


def step_distance(a, b):
    """(|loss difference|, max over BN state leaves and over gradients of
    max|d| / max|b|, max |d| over the weights after the step, share of
    weights with |d| > 1e-6)."""
    from dct_cryptonets_tpu_torch.models.resnet import tree_leaves

    def rel(pairs):
        return max(float(np.max(np.abs(g - c)) / max(np.max(np.abs(c)),
                                                     1e-30))
                   for g, c in pairs)

    dw = np.concatenate([np.abs(g - c).ravel().astype(np.float64)
                         for g, c in zip(tree_leaves(a[1]),
                                         tree_leaves(b[1]))])
    return (abs(a[0] - b[0]), rel(zip(tree_leaves(a[2]), tree_leaves(b[2]))),
            rel(zip(a[3], b[3])), float(dw.max()),
            float((dw > 1e-6).mean()))


def clear_and_simulate(ckpt, dev, model="ResNet20qat", n=359):
    """The eval flow on the digits (``homomorphic_eval.prepare``:
    calibration on the first 64 training images, exact rounding, n_bits 5,
    threshold 6; no checkpoint draws a random model): clear and simulate
    top-1 counts over the first ``n`` of its test images."""
    from dct_cryptonets_tpu_torch import homomorphic_eval as HE

    args = ["--dataset", "digits", "--dct_status", "--model", model,
            "--channels", "24", "--filter_size", "4", "--image_size_dct",
            "16", "--bit_width", "4", "--n_bits", "5",
            "--rounding_threshold_bits", "6", "--rounding_method", "exact",
            "--residual_mode", "fused", "--range_margin", "1.0",
            "--test_subset", "359"]
    if ckpt:
        args += ["--checkpoint_path", ckpt]
    s = HE.prepare(HE.parse_args("homomorphic_eval", args), dev)
    idx = s.test_idx[:n]
    clear, _ = HE.test_unencrypted(s.model, s.ingest, s.testset, idx, 64)
    clf_w = np.asarray(s.params["classifier"]["w"])
    clf_b = np.asarray(s.params["classifier"]["b"])
    feats = np.concatenate([s.module.forward(s.ingest(
        s.testset.gather(idx[i:i + 64])[0]).cpu().numpy(), fhe="simulate")
        for i in range(0, len(idx), 64)])
    if feats.shape != (len(idx), 64) or not np.all(np.isfinite(feats)):
        raise AssertionError(f"bad simulate features {feats.shape}")
    sim = int((np.argmax(feats @ clf_w + clf_b, 1)
               == s.testset.labels[idx]).sum())
    return round(clear.avg * len(idx) / 100), sim, len(idx), s


def payload_equal(a, b) -> bool:
    """Two checkpoint payloads hold the same weights, BN state and
    optimizer state, bit for bit."""
    from dct_cryptonets_tpu_torch.models.resnet import tree_leaves

    x = tree_leaves((a["state"], a["optimizer"]))
    y = tree_leaves((b["state"], b["optimizer"]))
    return len(x) == len(y) and all(
        np.array_equal(np.asarray(u), np.asarray(v)) for u, v in zip(x, y))


def phase_train(dev):
    """Phase 7: train on the card, then compile and simulate."""
    import shutil

    from dct_cryptonets_tpu_torch import train as TRAIN
    from dct_cryptonets_tpu_torch.checkpoint import load_ckpt

    t = time.time()
    steps, seen, convs, flag_after = train_steps(dev)
    f64 = step_distance(steps[torch.float64, "cuda"],
                        steps[torch.float64, "cpu"])
    f32 = step_distance(steps[torch.float32, "cuda"],
                        steps[torch.float32, "cpu"])
    ref = step_distance(steps[torch.float32, "cpu"],
                        steps[torch.float64, "cpu"])
    fmt = ("loss |d| {:.3e}, BN state max|d|/max {:.3e}, gradients "
           "max|d|/max {:.3e}, weights max|d| {:.3e}, share over 1e-6 "
           "{:.3e}").format
    print(f"  one Adam step (digits batch 128, ResNet20qat 24x16^2), "
          f"losses: float64 CPU {steps[torch.float64, 'cpu'][0]:.12f} / "
          f"CUDA {steps[torch.float64, 'cuda'][0]:.12f}, float32 CPU "
          f"{steps[torch.float32, 'cpu'][0]:.6f} / CUDA "
          f"{steps[torch.float32, 'cuda'][0]:.6f}; {time.time() - t:.1f} s"
          f"\n  float64, CUDA vs CPU: {fmt(*f64)} (tolerance 1e-9 on the "
          f"loss, BN state and gradients; Adam's first step moves a weight "
          f"by about the LR whatever its gradient's size, so a gradient "
          f"within rounding of 0 may step either way: weights within "
          f"2.1e-3, share over 1e-6 at most 1e-4)\n  float32, CUDA vs CPU: "
          f"{fmt(*f32)}\n  float32 "
          f"vs float64, both on the CPU: {fmt(*ref)} (a float32 rounding "
          f"flips ~1e-5 of the 4-bit fake-quant roundings, and each flip "
          f"moves the step; float32 is held to 4x this CPU spread and to "
          f"1 % of the loss)", flush=True)
    print(f"  float32 CUDA step with cuDNN's TF32 flag on: {len(seen)} "
          f"backward convolutions of {convs} ran, {sum(seen)} of them with "
          f"TF32 on; the flag after the step: {flag_after}", flush=True)
    if len(seen) != convs or any(seen) or flag_after is not True:
        raise AssertionError("a backward convolution of the train step ran "
                             "with TF32 on, or the caller's flag was lost")
    if max(f64[:3]) > 1e-9 or f64[3] > 2.1e-3 or f64[4] > 1e-4:
        raise AssertionError("the float64 CUDA train step disagrees with "
                             "the CPU's")
    if f32[0] > max(4 * ref[0], 1e-6) or f32[0] > 0.01 * abs(
            steps[torch.float32, "cpu"][0]):
        raise AssertionError("the float32 CUDA train step is further from "
                             "the CPU's than float32 rounding moves it")

    def recipe(name, epochs):
        ckdir = os.path.join(ROOT, "build", f"phase7_{name}")
        shutil.rmtree(ckdir, ignore_errors=True)
        args = TRAIN_ARGS[:-1] + [str(epochs), "--checkpoint_dir", ckdir]
        t = time.time()
        res = TRAIN.main_impl(TRAIN.parse_args("train", args))
        ep = res["epoch_s"]
        rest = res["steps"] // res["epochs"] * (len(ep) - 1) / max(
            sum(ep[1:]), 1e-9)
        print(f"  recipe, {name}: {res['epochs']} epochs, {res['steps']} steps in "
              f"{time.time() - t:.1f} s; s per epoch: first {ep[0]:.2f}, "
              f"median of the rest {float(np.median(ep[1:] or ep)):.2f}; "
              f"steps per s {res['steps'] / sum(ep):.2f}, after the first "
              f"epoch {rest:.2f}; best val top-1 {res['best_val']:.3f} %; "
              f"clear test top-1 "
              f"{res['test_top1']:.3f} % ({res['test_correct']}/"
              f"{res['test_total']})", flush=True)
        return res, load_ckpt(os.path.join(ckdir, f"{epochs - 1}.tar"))

    # reproducibility: the recipe's first epochs twice from one seed
    short = [recipe(f"short_{i}", SHORT_EPOCHS) for i in (1, 2)]
    same = payload_equal(short[0][1], short[1][1])
    print(f"  two {SHORT_EPOCHS}-epoch runs from one seed: weights, BN state "
          f"and optimizer state bit for bit "
          f"{'equal' if same else 'DIFFERENT'}", flush=True)
    if not same:
        raise AssertionError("two deterministic training runs from one seed "
                             "ended with different weights")
    res, _ = recipe("train", int(TRAIN_ARGS[-1]))
    if res["best_val"] < MIN_VAL_TOP1:
        raise AssertionError(f"best val top-1 {res['best_val']:.2f} % is "
                             f"under {MIN_VAL_TOP1} %")
    ckdir = os.path.join(ROOT, "build", "phase7_train")

    for name, ckpt in (("new checkpoint", os.path.join(ckdir, "best.tar")),
                       ("committed flagship", CKPT)):
        t = time.time()
        clear, sim, n, s = clear_and_simulate(ckpt, dev)
        jax_note = ("; JAX package: clear {}/359, simulate {}/359".format(
            *JAX_FLAGSHIP) if ckpt == CKPT else "")
        print(f"  {name}: clear {clear}/{n} ({100 * clear / n:.2f} %), "
              f"simulate {sim}/{n} ({100 * sim / n:.2f} %){jax_note}; "
              f"{s.module.circuit.num_pbs} PBS per image, max bit-width "
              f"{s.module.maximum_integer_bit_width()}; "
              f"{time.time() - t:.1f} s", flush=True)
        if 100 * (clear - sim) / n > MAX_SIM_DROP:
            raise AssertionError(f"{name}: simulate is more than "
                                 f"{MAX_SIM_DROP} points under clear")

    for model, kind in (("ResNet20", "PTQ"), ("ResNet20qat", "random-init")):
        t = time.time()
        clear, sim, n, s = clear_and_simulate(None, dev, model, n=4)
        print(f"  {kind} {model}: compiled {s.module.circuit.num_pbs} PBS "
              f"per image, max bit-width "
              f"{s.module.maximum_integer_bit_width()}; clear {clear}/{n}, "
              f"simulate {sim}/{n}; {time.time() - t:.1f} s", flush=True)


# phase 8: the data layer on the CIFAR-10 layout and the ResNet18 preset
CIFAR_DIR = os.path.join(ROOT, "build", "phase8_cifar")
PROFILE_DIR = os.path.join(ROOT, "build", "phase8_profile")
FOLDER_DIR = os.path.join(ROOT, "build", "phase8_imagenette")
CIFAR_BATCH, CIFAR_TEST = 10_000, 10_000      # images per data_batch_*, test
# the flagship's preset (scripts/run_train.sh, ResNet20qat) on cifar10
CIFAR_TRAIN_ARGS = ["--dataset", "cifar10", "--dataset_path", CIFAR_DIR,
                    "--dct_status", "--train_aug", "--model", "ResNet20qat",
                    "--channels", "24", "--filter_size", "4",
                    "--image_size_dct", "16", "--batch_size", "128",
                    "--test_batch_size", "256", "--lr", "0.001",
                    "--optimizer", "adam", "--stop_epoch", "1"]
CIFAR_EVAL_ARGS = ["--dataset", "cifar10", "--dataset_path", CIFAR_DIR,
                   "--dct_status", "--model", "ResNet20qat", "--channels",
                   "24", "--filter_size", "4", "--image_size_dct", "16",
                   "--bit_width", "4", "--n_bits", "5",
                   "--rounding_threshold_bits", "6", "--rounding_method",
                   "exact", "--residual_mode", "fused", "--range_margin",
                   "1.0", "--checkpoint_path", CKPT, "--fhe_mode",
                   "simulate"]
MIN_CIFAR_VAL_TOP1 = 30.0       # chance is 10 %
# (filter_size, image_size_dct, channels): the CIFAR preset and
# scripts/run_train.sh's ResNet18 preset (448-pixel crops)
CODEC_PRESETS = ((4, 16, 24), (8, 56, 64))
# the ResNet18 preset's training flags on the Imagenette folder fixture
FOLDER_TRAIN_ARGS = ["--dataset", "Imagenette", "--dataset_path",
                     FOLDER_DIR, "--dct_status", "--train_aug", "--model",
                     "ResNet18qat", "--channels", "64", "--filter_size", "8",
                     "--image_size_dct", "56", "--bit_width", "4",
                     "--batch_size", "16", "--test_batch_size", "16",
                     "--lr", "0.001", "--optimizer", "adam",
                     "--stop_epoch", "1"]
FOLDER_IMAGES = {"train": 8, "val": 2}        # PNGs per class


def class_templates(g, h, w, dev, classes=10):
    """Per class a 4 x 4 x 3 color draw in [64, 192), upscaled bilinearly
    to h x w: float32 (classes, 3, h, w), ``load_synthetic``'s templates."""
    import torch.nn.functional as F

    base = torch.randint(64, 192, (classes, 3, 4, 4), generator=g,
                         device=dev).to(torch.float32)
    return F.interpolate(base, size=(h, w), mode="bilinear",
                         align_corners=True)


def class_images(g, templates, labels):
    """uint8 (n, 3, h, w) images of ``labels``, class-structured as
    ``load_synthetic``'s: the label's template plus smooth noise (an 8 x 8
    N(0, 20) draw upscaled bilinearly), clipped to [0, 255]."""
    import torch.nn.functional as F

    n, (h, w) = len(labels), templates.shape[-2:]
    noise = 20 * torch.randn((n, 3, 8, 8), generator=g,
                             device=templates.device)
    noise = F.interpolate(noise, size=(h, w), mode="bilinear",
                          align_corners=True)
    return torch.clamp(templates[labels] + noise, 0, 255).to(torch.uint8)


def write_cifar10(root, dev, per_batch, n_test, seed=8):
    """The python-pickle CIFAR-10 layout under ``root/cifar-10-batches-py``:
    five ``data_batch_*`` of ``per_batch`` images and a ``test_batch`` of
    ``n_test``, each a uint8 (n, 3072) ``data`` (R, G, B planes of
    32 x 32) and a ``labels`` list, under the bytes keys the published
    batches load with."""
    d = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(d, exist_ok=True)
    g = torch.Generator(device=dev).manual_seed(seed)
    templates = class_templates(g, 32, 32, dev)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        n = n_test if name == "test_batch" else per_batch
        y = torch.randint(0, 10, (n,), generator=g, device=dev)
        x = class_images(g, templates, y).reshape(n, 3072)
        with open(os.path.join(d, name), "wb") as fh:
            pickle.dump({b"batch_label": name.encode(),
                         b"data": x.cpu().numpy(), b"labels": y.tolist()},
                        fh, protocol=4)


def write_imagenette(root, dev, per_class, seed=9):
    """An Imagenette ImageFolder fixture: ``train/`` and ``val/``, each
    with 10 class subdirectories of 500 x 375 class-structured PNGs."""
    from PIL import Image

    g = torch.Generator(device=dev).manual_seed(seed)
    templates = class_templates(g, 375, 500, dev)
    for split, n in per_class.items():
        for c in range(10):
            d = os.path.join(root, split, f"n{c:08d}")
            os.makedirs(d, exist_ok=True)
            imgs = class_images(g, templates, torch.full((n,), c, device=dev))
            for i, img in enumerate(imgs.permute(0, 2, 3, 1).cpu().numpy()):
                Image.fromarray(img).save(os.path.join(d, f"{i}.png"),
                                          compress_level=1)


def trace_kernel_events(profile_dir):
    """(trace file, count of CUDA kernel events) of the one
    ``torch.profiler`` trace in ``profile_dir``."""
    import glob

    files = glob.glob(os.path.join(profile_dir, "*.pt.trace.json"))
    if len(files) != 1:
        raise AssertionError(f"expected one trace file in {profile_dir}, "
                             f"found {files}")
    with open(files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    return files[0], sum(e.get("cat") == "kernel" for e in events)


def host_ms(fn, dev, reps=3):
    """Milliseconds per call of ``fn`` on the host clock, after one warm-up
    call, around work that ends in a device sync."""
    fn()
    return common.timed(lambda: [fn() for _ in range(reps)], dev)[1] \
        / reps * 1e3


# tolerances of the transforms on CUDA against the CPU, on the 0-255 scale
# (the same draws): flips, crops, padding, the luma and the salt-and-pepper
# select are bit for bit; the resizes, the color jitter and the noise sum
# float32 terms in another order; the warps' sample positions differ by
# ulps of the largest coordinate (cos, sin, tan and the 3x3 inverse on
# another library), and a random image's neighbours differ by up to 255,
# so their tolerance grows with the image: 255 * 16 ulps of max(H, W);
# the perspective's homography is solved and inverted by another library,
# its error carried by the 8x8 system's conditioning: 64 ulps of max(H, W)
def transform_cases(x, g):
    """{name: (fn(x on a device), tolerance)} of every deterministic
    transform of ``data/transforms.py`` at x's shape, on draws from the
    CPU generator ``g``."""
    from dct_cryptonets_tpu_torch.data import transforms as TR

    B, H, W, _ = x.shape
    warp = 255 * 16 * float(np.finfo(np.float32).eps) * max(H, W)
    flt = 1e-3
    top, left = TR.draw_crop(g, B, H + 4, W + 4, H // 2)
    flags = TR.draw_flags(g, B, 0.5)
    jitter = TR.draw_color_jitter(g, B, 0.4, 0.4, 0.4, 0.1)
    aff = TR.draw_affine(g, B, H, W, 20.0, (0.1, 0.1), (0.8, 1.2), 10.0)
    persp = TR.draw_perspective(g, B, H, W, 0.5, 0.5)
    noise = TR.draw_normal(g, tuple(x.shape))
    u = torch.rand((B, H, W, 1), generator=g)
    return {
        "resize": (lambda x: TR.resize(x, (H * 3 // 4, W + 5)), flt),
        "rescale": (lambda x: TR.rescale(x, 0.5), flt),
        "center_crop": (lambda x: TR.center_crop(x, H // 2), 0.0),
        "pad + crop": (lambda x: TR.crop(TR.pad(x, 2, 7.0), top, left,
                                         H // 2), 0.0),
        "hflip": (TR.hflip, 0.0), "vflip": (TR.vflip, 0.0),
        "flip where flagged": (lambda x: TR.where_flagged(
            flags, TR.hflip(x), x), 0.0),
        "grayscale": (TR.grayscale, 0.0),
        "jitter colors": (lambda x: TR.jitter_colors(x, *jitter), flt),
        "add noise": (lambda x: TR.add_noise(x, noise, 1.0, 10.0), flt),
        "salt and pepper": (lambda x: TR.salt_pepper(x, u, 0.05), 0.0),
        "rotate": (lambda x: TR.rotate(x, aff[0], fill=3.0), warp),
        "affine": (lambda x: TR.affine(x, *aff), warp),
        "warp corners": (lambda x: TR.warp_corners(x, *persp), 4 * warp),
        "compose": (TR.compose(TR.vflip, lambda x: TR.affine(x, *aff),
                               lambda x: TR.add_noise(x, noise)), warp),
    }


def phase_data(dev, card, have_pil):
    """Phase 8: the data layer on the card (no CMUX kernel)."""
    import shutil

    from dct_cryptonets_tpu_torch import homomorphic_eval as HE
    from dct_cryptonets_tpu_torch import train as TRAIN
    from dct_cryptonets_tpu_torch.data import codec as PC
    from dct_cryptonets_tpu_torch.data import native as NATIVE
    from dct_cryptonets_tpu_torch.data import pipeline
    from dct_cryptonets_tpu_torch.data import transforms as TR
    from dct_cryptonets_tpu_torch.models.resnet import QATResNet

    device_args = ["--device", dev.type]
    # a. the CIFAR-10 fixture at full size
    shutil.rmtree(CIFAR_DIR, ignore_errors=True)
    t = time.time()
    write_cifar10(CIFAR_DIR, dev, CIFAR_BATCH, CIFAR_TEST)
    train_ds = pipeline.get_dataset("cifar10", CIFAR_DIR, True)
    test_ds = pipeline.get_dataset("cifar10", CIFAR_DIR, False)
    print(f"  a. [{card}] CIFAR-10 fixture: {len(train_ds)} + "
          f"{len(test_ds)} images {train_ds.images.shape[1:]} "
          f"{train_ds.images.dtype}, classes {train_ds.classes[:2]}...; "
          f"written and loaded in "
          f"{time.time() - t:.1f} s", flush=True)
    if (train_ds.images.shape, test_ds.images.shape) != (
            (5 * CIFAR_BATCH, 32, 32, 3), (CIFAR_TEST, 32, 32, 3)):
        raise AssertionError("the CIFAR-10 fixture loads at another size")

    # b. the trainer on it at the flagship's preset, one epoch
    ckdir = os.path.join(ROOT, "build", "phase8_train")
    shutil.rmtree(ckdir, ignore_errors=True)
    t = time.time()
    res = TRAIN.main(CIFAR_TRAIN_ARGS + device_args
                     + ["--checkpoint_dir", ckdir])
    ep = res["epoch_s"]
    print(f"  b. [{card}] train cifar10 (ResNet20qat 24 x 16^2, batch 128, "
          f"--train_aug): {res['steps']} steps, {ep[0]:.2f} s per epoch, "
          f"{res['steps'] / sum(ep):.1f} steps per s; best val top-1 "
          f"{res['best_val']:.3f} %, test top-1 {res['test_top1']:.3f} % "
          f"({res['test_correct']}/{res['test_total']}); "
          f"{time.time() - t:.1f} s in all", flush=True)
    if res["steps"] != 5 * CIFAR_BATCH * 9 // 10 // 128:
        raise AssertionError(f"{res['steps']} train steps")
    if res["best_val"] < MIN_CIFAR_VAL_TOP1:
        raise AssertionError(f"best val top-1 {res['best_val']:.2f} % is "
                             f"under {MIN_CIFAR_VAL_TOP1} %")

    # c. the eval flow on it with the committed flagship, and --profile_dir
    t = time.time()
    s = HE.prepare(HE.parse_args("homomorphic_eval", CIFAR_EVAL_ARGS + [
        "--test_subset", "64"] + device_args), dev)
    clear, _ = HE.test_unencrypted(s.model, s.ingest, s.testset, s.test_idx,
                                   64)
    sim, _ = HE.test_encrypted(s.module, np.asarray(s.params["classifier"][
        "w"]), np.asarray(s.params["classifier"]["b"]), s.ingest, s.testset,
        s.test_idx, 64, "simulate")
    images = s.testset.gather(s.test_idx[:8])[0]
    x = PC.make_ingest(PC.CodecConfig(24, 4, 16), "cpu")(images)
    with torch.no_grad():
        want = QATResNet(s.params, s.state, s.spec).eval()(x)[1].argmax(1)
        got = s.model(x.to(dev))[1].argmax(1).cpu()
    print(f"  c. [{card}] committed flagship on the fixture's "
          f"{len(s.test_idx)} test images: clear top-1 {clear.avg:.3f} %, "
          f"simulate top-1 {sim.avg:.3f} % (digits weights on other data); "
          f"classes of 8 "
          f"on the card {got.tolist()}, on the CPU {want.tolist()}; "
          f"{time.time() - t:.1f} s", flush=True)
    if not torch.equal(got, want):
        raise AssertionError("the clear model's classes on the card differ "
                             "from the CPU's")
    shutil.rmtree(PROFILE_DIR, ignore_errors=True)
    t = time.time()
    HE.main(CIFAR_EVAL_ARGS + ["--test_subset", "8", "--profile_dir",
                               PROFILE_DIR] + device_args)
    path, kernels = trace_kernel_events(PROFILE_DIR)
    print(f"  c. [{card}] homomorphic_eval --profile_dir: "
          f"{os.path.relpath(path, ROOT)} "
          f"({os.path.getsize(path) / 1e6:.1f} MB), {kernels} CUDA kernel "
          f"events; {time.time() - t:.1f} s", flush=True)
    if dev.type == "cuda" and kernels == 0:
        raise AssertionError("the --profile_dir trace holds no CUDA kernel "
                             "event")

    # d. the native host codec against the card's dct_from_pixels
    for fs, S, ch in CODEC_PRESETS:
        cfg = PC.CodecConfig(ch, fs, S)
        crops = PC._eval_resize_crop(torch.as_tensor(test_ds.images[:64]),
                                     cfg.pixel_size).to(torch.uint8).numpy()
        host = NATIVE.dct_ingest_native(crops, cfg)
        on_dev = torch.as_tensor(crops, device=dev)
        card_out = PC.dct_from_pixels(on_dev, cfg).cpu().numpy()
        diff = np.abs(host - card_out)
        share = float((diff < 5e-2).mean())
        h_ms = host_ms(lambda: NATIVE.dct_ingest_native(crops, cfg),
                       torch.device("cpu"))
        d_ms = host_ms(lambda: PC.dct_from_pixels(on_dev, cfg), dev)
        print(f"  d. [{card}] native codec vs the card's dct_from_pixels, fs "
              f"{fs}, S {S}, {ch} ch on 64 x {cfg.pixel_size}^2 crops: "
              f"{100 * share:.3f} % of elements within 5e-2, max |d| "
              f"{diff.max():.3g} (tolerance: 99 %, < 2); host "
              f"{64e3 / h_ms:.0f} images per s ({min(os.cpu_count() or 1, 8)}"
              f" threads), card {64e3 / d_ms:.0f} images per s", flush=True)
        if share <= 0.99 or diff.max() >= 2.0:
            raise AssertionError(f"native codec fs {fs} S {S} disagrees with "
                                 "the card's")

    # e. every deterministic transform on CUDA against the CPU, same draws
    gen = torch.Generator().manual_seed(10)
    for B, P in ((128, 32), (16, 448)):
        x = torch.rand((B, P, P, 3), generator=gen) * 255
        worst = []
        for name, (fn, tol) in transform_cases(x, gen).items():
            err = float((fn(x.to(dev)).cpu() - fn(x)).abs().max())
            worst.append(f"{name} {err:.2g}")
            if err > tol:
                raise AssertionError(f"transform {name} at {B} x {P}^2: "
                                     f"CUDA is {err} off the CPU (tolerance "
                                     f"{tol})")
        print(f"  e. transforms on {dev.type} against the CPU, {B} x {P}^2, "
              "max |d|: " + ", ".join(worst), flush=True)
    x = torch.rand((128, 224, 224, 3), generator=gen).to(dev) * 255
    dgen = torch.Generator(device=dev).manual_seed(11)
    aug = TR.compose(
        lambda y: TR.random_affine(dgen, y, 15.0, (0.1, 0.1), (0.9, 1.1),
                                   5.0),
        lambda y: TR.color_jitter(dgen, y, 0.4, 0.4, 0.4, 0.1),
        lambda y: TR.random_hflip(dgen, y),
        lambda y: TR.gaussian_noise(dgen, y, std=5.0))
    ms = host_ms(lambda: aug(x), dev, reps=5)
    print(f"  e. [{card}] random_affine -> color_jitter -> random_hflip -> "
          f"gaussian_noise on 128 x 224^2: {ms:.2f} ms, "
          f"{128e3 / ms:.0f} images per s", flush=True)

    # f. an Imagenette folder through a few train steps of ResNet18qat
    if not have_pil:
        print("  f. Pillow is not installed: the folder and manifest "
              "loaders ran in the CPU tests only", flush=True)
        return
    shutil.rmtree(FOLDER_DIR, ignore_errors=True)
    t = time.time()
    write_imagenette(FOLDER_DIR, dev, FOLDER_IMAGES)
    print(f"  f. [{card}] Imagenette fixture (10 classes of 500 x 375 PNGs, "
          f"{FOLDER_IMAGES}): {time.time() - t:.1f} s", flush=True)
    t = time.time()
    res = TRAIN.main(FOLDER_TRAIN_ARGS + device_args + [
        "--checkpoint_dir", os.path.join(ROOT, "build", "phase8_r18")])
    print(f"  f. [{card}] train Imagenette (ResNet18qat 64 x 56^2 on 448^2 "
          f"crops, batch 16): {res['steps']} steps in {res['epoch_s'][0]:.2f}"
          f" s, val top-1 {res['best_val']:.3f} %, test top-1 "
          f"{res['test_top1']:.3f} % ({res['test_total']} images); "
          f"{time.time() - t:.1f} s in all", flush=True)
    n_train = 10 * FOLDER_IMAGES["train"]
    if res["steps"] != (n_train - int(np.ceil(0.1 * n_train))) // 16 or \
            res["test_total"] != 10 * FOLDER_IMAGES["val"]:
        raise AssertionError("the Imagenette run took other steps or "
                             "tested other images")


PHASE9_DIR = os.path.join(ROOT, "build", "phase9")
PHASE9_TIMEOUT = 110            # seconds the two ranks may take together
PHASE9_PBS = (6, 51)            # table bits and output scale of the chunk
PHASE9_CLEAR = (10, 2, (2, 1, 5, 3, 0))   # n_in, bits, extraction knobs
RESNET18_PRESET = (64, 8, 56)   # channels, filter size, S (448-px crops)


def train_step_f64(params, state, images, labels, dev, rows=None):
    """One Adam step of the flagship recipe (``TRAIN_ARGS``: augmentation
    on, generator 1234 as the trainer's) in float64 on ``dev``; with
    ``rows``, this rank's rows of a step over the initialized process
    group.  Returns (loss, params, state, this rank's ingested input)."""
    import torch.distributed as dist

    from dct_cryptonets_tpu_torch import train as TRAIN
    from dct_cryptonets_tpu_torch.data.codec import CodecConfig
    from dct_cryptonets_tpu_torch.models.resnet import QATResNet, build_spec

    cfg = TRAIN.parse_args("train", TRAIN_ARGS)
    spec = build_spec("ResNet20qat", in_channels=24, img_size=16)
    ingest = TRAIN.make_ingest(cfg, CodecConfig(24, 4, 16), dev)
    gen = torch.Generator().manual_seed(1234)
    x = ingest(images, train=True, generator=gen, rows=rows)
    y = torch.as_tensor(labels.astype(np.int64), device=dev)
    model = QATResNet.from_params(params, state, spec).to(dev, torch.float64)
    shard = None
    if rows is not None:
        model.data_parallel(dist.group.WORLD)
        y, shard = y[rows], (rows, len(labels))
    opt = TRAIN.make_optimizer(cfg, cfg.lr, model.parameters())
    loss, _ = TRAIN.train_step(model, opt, cfg, x.double(), y, gen, shard)
    return float(loss), *model.to_params(), x.cpu().numpy()


def phase9_inputs(s, dev):
    """Phase 9's inputs and the one-process results the two ranks are held
    to, under build/phase9/: phase 3's server keys as numpy, one
    production chunk per lattice and its unsharded output (kernel engine),
    the training step's inputs and its one-process float64 step, and the
    ResNet18-preset image and its unsharded ingest.  Returns the
    one-process seconds of each part."""
    from dct_cryptonets_tpu_torch.data import pipeline
    from dct_cryptonets_tpu_torch.data.codec import CodecConfig, dct_ingest
    from dct_cryptonets_tpu_torch.fhe import encrypt_lwe
    from dct_cryptonets_tpu_torch.fhe import pbs as P
    from dct_cryptonets_tpu_torch.models.resnet import (build_spec,
                                                        calibrate_scales,
                                                        init_model)
    from dct_cryptonets_tpu_torch.parallel import data_mesh
    from dct_cryptonets_tpu_torch.data import dct_ingest_sharded

    m = s.module
    par, cfg, ck = m.params, m.exact_cfg, m.client_keys
    os.makedirs(PHASE9_DIR, exist_ok=True)
    secs = {}
    keys = {f"main_{k}": v for k, v in m.device_keys._asdict().items()}
    keys.update({f"aux_{k}": v for k, v in m.aux_keys._asdict().items()
                 if v is not None})          # no strip table under the gate
    nbytes = 0
    for k, v in keys.items():
        np.save(os.path.join(PHASE9_DIR, f"{k}.npy"), v.cpu().numpy())
        nbytes += v.numel() * v.element_size()
    rng = np.random.default_rng(19)
    r, out_log2 = PHASE9_PBS
    n_in, shift, knobs = PHASE9_CLEAR

    def fresh(msgs, delta_log2):
        return encrypt_lwe(ck, msgs.astype(np.uint64) << np.uint64(
            delta_log2), rng, key=ck.big_lwe_key,
            noise_log2=par.glwe_noise_log2).view(np.int64)

    chunks = {"main_ct": fresh(rng.integers(0, 2 ** r, IMAGE_M), 64 - r - 1),
              "main_tables": rng.integers(-2 ** 11, 2 ** 11, (
                  IMAGE_M, 2 ** r)).astype(np.int32),
              "aux_ct": fresh(rng.integers(0, 1 << n_in, IMAGE_M),
                              63 - n_in)}
    t = {k: torch.as_tensor(v, device=dev) for k, v in chunks.items()}
    chunks["main_out"], secs["bootstrap chunk"] = common.timed(
        lambda: P.bootstrap(t["main_ct"], t["main_tables"], m.device_keys,
                            par, out_log2).cpu().numpy(), dev)
    chunks["aux_out"], secs["clear_low_bits chunk"] = common.timed(
        lambda: P.clear_low_bits(
            t["aux_ct"], m.aux_keys, cfg.aux, n_in, shift, cfg.back_base_log,
            cfg.back_levels, *knobs).cpu().numpy(), dev)

    spec = build_spec("ResNet20qat", in_channels=24, img_size=16)
    ds = pipeline.get_dataset("digits", None, True, image_size=64)
    params, state = init_model(spec)
    params = calibrate_scales(params, state, dct_ingest(
        ds.images[:64], CodecConfig(24, 4, 16)), spec)
    images, labels = ds.images[64:192], ds.labels[64:192]
    step, secs["train step"] = common.timed(lambda: train_step_f64(
        params, state, images, labels, dev), dev)

    ch, fs, S = RESNET18_PRESET
    icfg = CodecConfig(ch, fs, S)
    img = np.random.default_rng(20).integers(
        0, 256, (1, fs * S, fs * S, 3)).astype(np.uint8)
    ref = dct_ingest(torch.as_tensor(img, device=dev), icfg)
    one_card = dct_ingest_sharded(torch.as_tensor(img, device=dev), icfg,
                                  data_mesh(4))
    print(f"  ingest at the ResNet18 preset, 4-entry one-card mesh == "
          f"dct_ingest: {torch.equal(one_card, ref)}", flush=True)
    if not torch.equal(one_card, ref):
        raise AssertionError("the sharded ingest on a 4-entry one-card mesh "
                             "differs from dct_ingest")
    np.savez(os.path.join(PHASE9_DIR, "chunks.npz"), **chunks)
    with open(os.path.join(PHASE9_DIR, "inputs.pkl"), "wb") as fh:
        pickle.dump({"par": par, "exact_cfg": cfg, "params": params,
                     "state": state, "images": images, "labels": labels,
                     "step": step, "image": img,
                     "ingest": ref.cpu().numpy(), "key_bytes": nbytes}, fh)
    print(f"  one process: {secs['bootstrap chunk']:.2f} s bootstrap chunk "
          f"(M={IMAGE_M}), {secs['clear_low_bits chunk']:.2f} s "
          f"clear_low_bits chunk ({shift} bits at aux {knobs[:2]}, "
          f"keyswitch drops {knobs[2:4]}), {secs['train step']:.2f} s "
          f"float64 train step (batch {len(labels)}); key bytes "
          f"{nbytes / 1e6:.1f} MB", flush=True)
    return secs


def phase9_worker(rank, address):
    """One of the two ranks on the one card (gloo): key broadcast, its half
    of each production chunk, one data-parallel train step and the
    sharded ingest over the two processes; rank 0 checks the gathered
    results against the one-process ones and writes result.json."""
    import torch.distributed as dist

    from dct_cryptonets_tpu_torch.data import dct_ingest_sharded
    from dct_cryptonets_tpu_torch.data.codec import CodecConfig
    from dct_cryptonets_tpu_torch.fhe import pbs as P
    from dct_cryptonets_tpu_torch.fhe.runtime import CompiledModule
    from dct_cryptonets_tpu_torch.models.resnet import tree_leaves
    from dct_cryptonets_tpu_torch.parallel import (global_data_mesh,
                                                   initialize, shard_batch)
    from dct_cryptonets_tpu_torch.parallel.distributed import shutdown
    from dct_cryptonets_tpu_torch.parallel.mesh import run_sharded, shard_rows

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    backend = initialize(address, 2, rank, devices=[dev],
                         timeout=PHASE9_TIMEOUT)
    if backend != "gloo":
        raise AssertionError(f"two ranks on one card ran {backend}")
    K.build_kernels()                       # phase 1's build, loaded
    with open(os.path.join(PHASE9_DIR, "inputs.pkl"), "rb") as fh:
        inp = pickle.load(fh)
    par, cfg = inp["par"], inp["exact_cfg"]
    mesh = global_data_mesh()
    times = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        dist.barrier()
        t = time.time()
        out = fn()
        torch.cuda.synchronize()
        times[name] = time.time() - t
        dist.barrier()
        times[name + ", both ranks"] = time.time() - t
        return out

    m = CompiledModule(None, par, device=dev)
    if rank == 0:
        def load(prefix, cls):
            paths = {f: os.path.join(PHASE9_DIR, f"{prefix}_{f}.npy")
                     for f in cls._fields}
            return cls(**{f: torch.from_numpy(np.load(p)).to(dev)
                          for f, p in paths.items() if os.path.exists(p)})
        m.device_keys = load("main", P.DeviceServerKeys)
        m.aux_keys = load("aux", P.DeviceAuxKeys)
    timed("key broadcast", lambda: m.shard_over(mesh))
    chunks = np.load(os.path.join(PHASE9_DIR, "chunks.npz"))
    r, out_log2 = PHASE9_PBS
    n_in, shift, knobs = PHASE9_CLEAR
    main_ct, tables, aux_ct = shard_batch(mesh, (
        chunks["main_ct"], chunks["main_tables"], chunks["aux_ct"]))
    K.reset_launch_counts()
    boot = timed("bootstrap chunk", lambda: run_sharded(
        mesh, lambda c, t, k: P.bootstrap(c, t, k[0], par, out_log2),
        main_ct, tables, m.replicas[1]))
    clear = timed("clear_low_bits chunk", lambda: run_sharded(
        mesh, lambda c, k: P.clear_low_bits(
            c, k[1], cfg.aux, n_in, shift, cfg.back_base_log,
            cfg.back_levels, *knobs), aux_ct, m.replicas[1]))
    counts = K.launch_counts()
    boot, clear = boot.gather(), clear.gather()

    rows = shard_rows(len(inp["labels"]), mesh, rank)
    step = timed("train step", lambda: train_step_f64(
        inp["params"], inp["state"], inp["images"], inp["labels"], dev,
        rows))
    ch, fs, S = RESNET18_PRESET
    ingest = timed("sharded ingest", lambda: dct_ingest_sharded(
        torch.as_tensor(inp["image"], device=dev), CodecConfig(ch, fs, S),
        mesh))
    all_counts, all_times = [None, None], [None, None]
    dist.all_gather_object(all_counts, counts)
    dist.all_gather_object(all_times, times)
    if rank == 0:
        ref = inp["step"]
        d_loss = abs(step[0] - ref[0])
        d_tree = max(float(np.max(np.abs(np.asarray(g) - np.asarray(w))))
                     for g, w in zip(tree_leaves(step[1:3]),
                                     tree_leaves(ref[1:3])))
        d_x = float(np.max(np.abs(step[3] - ref[3][rows])))
        res = {"backend": backend, "mesh": [str(d) for d in mesh.devices],
               "ranks": list(mesh.ranks), "key_bytes": inp["key_bytes"],
               "launches": all_counts, "times": all_times,
               "bootstrap_equal": bool(np.array_equal(
                   boot.cpu().numpy(), chunks["main_out"])),
               "clear_low_bits_equal": bool(np.array_equal(
                   clear.cpu().numpy(), chunks["aux_out"])),
               "train_loss_diff": d_loss, "train_state_max_diff": d_tree,
               "train_input_max_diff": d_x,
               "ingest_equal": bool(np.array_equal(ingest.cpu().numpy(),
                                                   inp["ingest"]))}
        with open(os.path.join(PHASE9_DIR, "result.json"), "w") as fh:
            json.dump(res, fh)
    shutdown()


def phase_sharded(s, dev, image_s):
    """Phase 9: the sharded paths.  a. phase 5's image ran on the mesh
    path; b.-d. two processes on the one card (gloo) against the
    one-process results.  Returns both ranks' launch counts, summed."""
    from dct_cryptonets_tpu_torch.parallel.distributed import free_port

    t = time.time()
    one = phase9_inputs(s, dev)
    print(f"  a. flagship image on the mesh path (phase 5): {image_s:.1f} s;"
          f" inputs and one-process results: {time.time() - t:.1f} s",
          flush=True)
    result = os.path.join(PHASE9_DIR, "result.json")
    if os.path.exists(result):
        os.remove(result)
    t = time.time()
    ctx = torch.multiprocessing.start_processes(
        phase9_worker, args=(f"localhost:{free_port()}",), nprocs=2,
        join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=1):
            if time.time() - t > PHASE9_TIMEOUT:
                raise TimeoutError(f"phase 9's ranks ran over "
                                   f"{PHASE9_TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(10)
    with open(result) as fh:
        res = json.load(fh)
    print(f"  two ranks ({res['backend']}, mesh {res['mesh']}, ranks "
          f"{res['ranks']}): {time.time() - t:.1f} s with start-up",
          flush=True)
    for rank, times in enumerate(res["times"]):
        print(f"  rank {rank}: " + ", ".join(
            f"{k} {v:.2f} s" for k, v in times.items()), flush=True)
    t0 = res["times"][0]
    print(f"  b. key broadcast: {res['key_bytes'] / 1e6:.1f} MB in "
          f"{t0['key broadcast, both ranks']:.2f} s; bootstrap chunk "
          f"(M={IMAGE_M}): two ranks {t0['bootstrap chunk, both ranks']:.2f}"
          f" s, one rank {one['bootstrap chunk']:.2f} s; clear_low_bits "
          f"chunk: two ranks {t0['clear_low_bits chunk, both ranks']:.2f} s,"
          f" one rank {one['clear_low_bits chunk']:.2f} s; gathered == "
          f"unsharded: bootstrap {res['bootstrap_equal']}, clear_low_bits "
          f"{res['clear_low_bits_equal']}; launches per rank "
          f"{res['launches']}", flush=True)
    print(f"  c. train step over two ranks: {t0['train step, both ranks']:.2f}"
          f" s (one process {one['train step']:.2f} s); |loss - one "
          f"process| {res['train_loss_diff']:.3g}, max |params, state - one "
          f"process| {res['train_state_max_diff']:.3g}, max |input - one "
          f"process's rows| {res['train_input_max_diff']:.3g}", flush=True)
    print(f"  d. sharded ingest over the two ranks at the ResNet18 preset "
          f"== dct_ingest: {res['ingest_equal']} "
          f"({t0['sharded ingest, both ranks']:.2f} s)", flush=True)
    bad = [k for k in ("bootstrap_equal", "clear_low_bits_equal",
                       "ingest_equal") if not res[k]]
    if bad:
        raise AssertionError(f"phase 9: sharded != unsharded: {bad}")
    if max(res["train_loss_diff"], res["train_state_max_diff"]) > 1e-9:
        raise AssertionError("phase 9: the two-rank train step is off the "
                             "one-process step by more than 1e-9")
    missing = [(r, k) for r, c in enumerate(res["launches"])
               for k in FUSED_KERNELS if c[k] == 0]
    if missing:
        raise AssertionError(f"phase 9: kernels not launched: {missing}")
    return {k: sum(c[k] for c in res["launches"]) for k in KERNELS}


# phase 10: the extraction chunk of phase 4's audit knob, fed from the table
TABLE_CHUNK = (10, 2, (2, 1, 5, 3, 1))    # n_in, shift, extraction knobs


def phase_strip_table(m, dev, record):
    """Phase 10: the extraction lattice's precomputed strip table.  Under
    the default gate keygen builds none for the flagship; with the gate
    raised through ``max_bytes`` it is built at the audit's aux knob, one
    K2 launch, equal to K2's plain version on the same key bytes, each
    step's entry equal to the step's own strips; one
    extraction chunk fed from it equals the per-step one bit for bit.
    Returns the launch counts of the path run (the build and the
    table-fed chunk) and adds K2's table build and K3 on a table slice to
    ``record``."""
    from dct_cryptonets_tpu_torch.fhe import encrypt_lwe
    from dct_cryptonets_tpu_torch.fhe import pbs as P

    par, cfg, ck, ak = m.params, m.exact_cfg, m.client_keys, m.aux_keys
    aux = cfg.aux
    k, N, levels, n = (aux.glwe_dim, aux.poly_size, aux.pbs_levels,
                       aux.lwe_dim)
    n_in, shift, knobs = TABLE_CHUNK
    drop, cross = knobs[:2]
    gate = 2 * 1024 ** 3
    sizes = {d: P.strip_table_bytes(ak, d) for d in (0, drop)}
    gated = P.with_precomputed_strips(ak, aux, drop)
    print(f"  default gate ({os.environ.get('DCTC_STRIP_TABLE_BYTES', gate)} "
          f"bytes): the flagship's table would hold {sizes[0] / 1e9:.2f} GB "
          f"at drop 0 and {sizes[drop] / 1e9:.2f} GB at drop {drop}; "
          f"phase 3's keygen built {ak.bigd_bytes is not None}, at drop "
          f"{drop} built {gated.bigd_bytes is not None}", flush=True)
    if ak.bigd_bytes is not None or gated.bigd_bytes is not None:
        raise AssertionError("a strip table was built under the default gate")

    rng = np.random.default_rng(23)
    v = rng.integers(0, 1 << n_in, IMAGE_M)
    ct = T.from_u64(encrypt_lwe(
        ck, v.astype(np.uint64) << np.uint64(63 - n_in), rng,
        key=ck.big_lwe_key, noise_log2=par.glwe_noise_log2), dev)

    def chunk(keys):
        return P.clear_low_bits(ct, keys, aux, n_in, shift, cfg.back_base_log,
                                cfg.back_levels, *knobs)

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    K.reset_launch_counts()
    keys, build_s = common.timed(
        lambda: P.with_precomputed_strips(ak, aux, drop,
                                          max_bytes=sizes[drop]), dev)
    fed, fed_s = common.timed(lambda: chunk(keys), dev)
    launches = K.launch_counts()
    table = keys.bigd_bytes
    want = {name: 0 for name in KERNELS}
    want.update(build_bigd_strips=1, rotate_decompose=(shift - knobs[4]) * n,
                fused_external=(shift - knobs[4]) * n)
    print(f"  table at aux ({drop},{cross}): {tuple(table.shape)}, "
          f"{table.numel() / 1e9:.3f} GB, built in {build_s:.3f} s (peak "
          f"{(torch.cuda.max_memory_allocated() - base) / 1e9:.2f} GB over "
          f"the keys); launches in the build and the table-fed chunk "
          f"{launches}", flush=True)
    if table is None or table.numel() != sizes[drop] or launches != want:
        raise AssertionError(f"the table path launched {launches}, "
                             f"expected {want}")
    # the whole table (one K2 launch, byte offsets past 2^31) against K2's
    # plain version on the same key bytes
    dbl = ak.bsk_bytes[..., drop:].permute(0, 2, 4, 1, 3).reshape(
        n * (k + 1), (8 - drop) * (k + 1) * levels, 2 * N)
    plain = K.build_bigd_strips_plain(dbl, True)
    same = torch.equal(table.view(plain.shape), plain)
    print(f"  the table ({table.numel() / 1e9:.3f} GB) against K2's plain "
          f"version on the same key bytes: "
          f"{'equal' if same else 'DIFFERENT'}", flush=True)
    if not same:
        raise AssertionError("the strip table differs from K2's plain "
                             "version")
    del plain
    for i in (0, 1, n // 2, n - 1):
        step = K.build_bigd_strips(P._bigd_rows(ak.bsk_bytes[i], k, levels, N,
                                                drop), k_major=True)
        if not torch.equal(table[i], step):
            raise AssertionError(f"table entry {i} differs from step {i}'s "
                                 "strips")
    per_step, step_s = common.timed(lambda: chunk(ak), dev)
    if not torch.equal(fed, per_step):
        raise AssertionError("the table-fed extraction chunk differs from "
                             "the per-step one")
    # in turns: per-step, table, table, per-step
    secs = {"table": [fed_s], "per-step": [step_s]}
    for name in ("per-step", "table", "table", "per-step"):
        secs[name].append(common.timed(
            lambda: chunk(keys if name == "table" else ak), dev)[1])
    print(f"  one {IMAGE_M}-ciphertext clear_low_bits chunk at aux "
          f"({drop},{cross}), keyswitch drops {knobs[2:4]}, keep_low "
          f"{knobs[4]} ({(shift - knobs[4]) * n} CMUX steps): table-fed == "
          f"per-step (bit for bit); s: table " + ", ".join(
              f"{x:.4f}" for x in secs["table"]) + "; per-step " + ", ".join(
              f"{x:.4f}" for x in secs["per-step"]), flush=True)

    # K2 over the whole table and K3 on one table slice, timed
    idx = (-K._strip_index(N, dev)) % (2 * N)
    record["build_bigd_strips"][f"aux drop={drop} table"] = (
        cuda_ms(lambda: K.build_bigd_strips(dbl, True), reps=3),
        cuda_ms(lambda: K.build_bigd_strips_plain(dbl, True), reps=1),
        cuda_ms(lambda: dbl[:, :, idx], reps=1), IMAGE_M, drop, 0, n)
    rows = (k + 1) * levels
    gen = torch.Generator(device=dev).manual_seed(29)
    acc = rand_i64(gen, (k + 1, IMAGE_M, N), dev)
    d0 = torch.randint(-128, 128, (rows, IMAGE_M, N), generator=gen,
                       device=dev, dtype=torch.int8)
    d1 = torch.randint(-64, 65, (rows, IMAGE_M, N), generator=gen, device=dev,
                       dtype=torch.int8)
    args = (d0, d1, table[n // 2], acc, drop, cross)
    if not torch.equal(K.fused_external(*args), K.fused_external_plain(*args)):
        raise AssertionError("K3 on a table slice differs from its plain "
                             "version")
    record["fused_external"][f"aux drop={drop} cross={cross} table"] = (
        cuda_ms(lambda: K.fused_external(*args)),
        cuda_ms(lambda: K.fused_external_plain(*args), reps=2),
        library_ms(k + 1, N, rows, IMAGE_M, drop), IMAGE_M, drop, cross)
    for name, lat in (("build_bigd_strips", f"aux drop={drop} table"),
                      ("fused_external", f"aux drop={drop} cross={cross} "
                       "table"),
                      ("fused_external", f"aux drop={drop} cross={cross}")):
        print_timing(record, name, lat)
    del keys, table, fed, per_step, dbl, args, d0, d1, acc
    torch.cuda.empty_cache()
    print(f"  table freed: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
          "allocated", flush=True)
    return launches


# phase 11: the main lattices of presets 7 and 8 (k=1), and ResNet-18 at
# the reference's ImageNet row (reference README.md:92)
LARGE = {"p7": 7, "p8": 8}
LARGE_M = (64, 129, 2048, 4097)
LARGE_KNOBS = ((0, 0), (2, 1), (3, 0), (4, 1), (7, 0))
LARGE_TIMED = ((0, 0), (2, 1))
# ResNet18qat's fused circuit at 64 ch x 56^2 (structural: the TLU sites)
IMAGENET_PBS = 1_706_496


def phase_large_kernels(dev, record):
    """Phase 11a: every kernel against its plain version at N=4096 and
    N=8192; adds the timings at M=2048 to ``record``; returns each
    kernel's largest |error|."""
    gen = torch.Generator(device=dev).manual_seed(4321)
    errs = {name: 0 for name in KERNELS}

    def check(name, got, want, what):
        errs[name] = max(errs[name], max_abs_err(got, want))
        if not all(torch.equal(g, w) for g, w in zip(
                got if isinstance(got, tuple) else (got,),
                want if isinstance(want, tuple) else (want,))):
            raise AssertionError(f"{name} {what} differs from its plain "
                                 "version")

    for lat in LARGE:
        J, N, rows, Mprod = LATTICES[lat]
        for M in LARGE_M:
            acc = rand_i64(gen, (J, M, N), dev)
            amt = torch.randint(0, 2 * N, (M,), generator=gen, device=dev,
                                dtype=torch.int32)
            amt[:3] = torch.tensor([0, N, 2 * N - 1], device=dev)
            args = (acc, amt, 15, 2)
            check("rotate_decompose", K.rotate_decompose(*args),
                  K.rotate_decompose_plain(*args), f"{lat} M={M}")
            sm = acc.transpose(0, 1).contiguous()
            sargs = (sm, amt, 15, 2, False)
            check("rotate_decompose", K.rotate_decompose(*sargs),
                  K.rotate_decompose_plain(*sargs),
                  f"{lat} sample-major M={M}")
            check("rotate_diff", K.rotate_diff(sm, amt),
                  K.rotate_diff_plain(sm, amt), f"{lat} M={M}")
            for drop, cross in ((0, 0), (2, 1)):
                o0, o1 = (torch.randint(
                    -2 ** 31, 2 ** 31 - 1, (M, J * (8 - drop), N),
                    generator=gen, device=dev, dtype=torch.int32)
                    for _ in range(2))
                kargs = (o0, o1, sm, drop, cross)
                check("combine_accumulate", K.combine_accumulate(*kargs),
                      K.combine_accumulate_plain(*kargs),
                      f"{lat} drop={drop} cross={cross} M={M}")
                if M == Mprod and drop == 0:
                    record["combine_accumulate"][lat] = (
                        cuda_ms(lambda: K.combine_accumulate(*kargs)),
                        cuda_ms(lambda: K.combine_accumulate_plain(*kargs)),
                        None, M, 0, 0)
            if M == Mprod:
                record["rotate_decompose"][lat] = (
                    cuda_ms(lambda: K.rotate_decompose(*args)),
                    cuda_ms(lambda: K.rotate_decompose_plain(*args)), None,
                    M, 0, 0)
                record["rotate_decompose sample-major"][lat] = (
                    cuda_ms(lambda: K.rotate_decompose(*sargs)),
                    cuda_ms(lambda: K.rotate_decompose_plain(*sargs)), None,
                    M, 0, 0)
                record["rotate_diff"][lat] = (
                    cuda_ms(lambda: K.rotate_diff(sm, amt)),
                    cuda_ms(lambda: K.rotate_diff_plain(sm, amt)), None, M,
                    0, 0)
            del acc, sm, o0, o1, kargs
        print(f"  {lat} (N={N}): K1 both layouts, K5, K4 at (0,0) and (2,1) "
              f"equal at M in {LARGE_M}", flush=True)
        strips = {}
        for drop in sorted({0, 2, 4} | {d for d, _ in LARGE_KNOBS}):
            dbl = torch.randint(-128, 128, (J, (8 - drop) * rows, 2 * N),
                                generator=gen, device=dev, dtype=torch.int8)
            if drop in (0, 2, 4):
                for km in (False, True):
                    check("build_bigd_strips", K.build_bigd_strips(dbl, km),
                          K.build_bigd_strips_plain(dbl, km),
                          f"{lat} drop={drop} k_major={km}")
            if drop == 0:
                idx = (-K._strip_index(N, dev)) % (2 * N)
                record["build_bigd_strips"][lat] = (
                    cuda_ms(lambda: K.build_bigd_strips(dbl, True)),
                    cuda_ms(lambda: K.build_bigd_strips_plain(dbl, True)),
                    cuda_ms(lambda: dbl[:, :, idx]), Mprod, 0, 0)
            strips[drop] = K.build_bigd_strips(dbl, k_major=True)
        for drop, cross in LARGE_KNOBS:
            for M in LARGE_M:
                acc = rand_i64(gen, (J, M, N), dev)
                d0 = torch.randint(-128, 128, (rows, M, N), generator=gen,
                                   device=dev, dtype=torch.int8)
                d1 = torch.randint(-64, 65, (rows, M, N), generator=gen,
                                   device=dev, dtype=torch.int8)
                args = (d0, d1, strips[drop], acc, drop, cross)
                check("fused_external", K.fused_external(*args),
                      K.fused_external_plain(*args),
                      f"{lat} drop={drop} cross={cross} M={M}")
                if M == Mprod and (drop, cross) in LARGE_TIMED:
                    key = lat if drop == cross == 0 else knob_key(lat, drop,
                                                                  cross)
                    record["fused_external"][key] = (
                        cuda_ms(lambda: K.fused_external(*args), reps=5),
                        cuda_ms(lambda: K.fused_external_plain(*args),
                                reps=1),
                        library_ms(J, N, rows, M, drop), M, drop, cross)
                del acc, d0, d1, args
        print(f"  {lat} (N={N}): K2 at drops 0, 2, 4 and K3 at (drop, "
              f"cross) in {LARGE_KNOBS} equal at M in {LARGE_M}", flush=True)
        del strips
        torch.cuda.empty_cache()
    for name, per in record.items():
        for lat in per:
            if lat.split()[0] in LARGE:
                print_timing(record, name, lat)
    return errs


def random_server_keys(par, dev, seed):
    """Server keys of random bytes in ``pbs.preprocess_server_keys``'s
    layout: the kernel engine against the plain engine needs no
    decryption."""
    from dct_cryptonets_tpu_torch.fhe import pbs as P

    g = torch.Generator(device=dev).manual_seed(seed)
    k, N, n = par.glwe_dim, par.poly_size, par.lwe_dim
    rows = (k + 1) * par.pbs_levels
    return P.DeviceServerKeys(
        torch.randint(-128, 128, (n, rows, k + 1, 2 * N, 8), generator=g,
                      device=dev, dtype=torch.int8),
        torch.randint(-128, 128, (k * N * par.ks_levels, n + 1, 8),
                      generator=g, device=dev, dtype=torch.int8))


def phase_large_bootstraps(dev):
    """Phase 11b: one 64-ciphertext bootstrap chunk at presets 7 and 8 on
    random key bytes, kernel engine == plain engine.  Returns the launch
    counts of the kernel-engine runs."""
    from dct_cryptonets_tpu_torch.fhe import pbs as P
    from dct_cryptonets_tpu_torch.fhe.params import _PRESETS

    launches = {name: 0 for name in KERNELS}
    for preset in LARGE.values():
        par = _PRESETS[preset]
        dsk = random_server_keys(par, dev, preset)
        g = torch.Generator(device=dev).manual_seed(preset + 1)
        M, kN = 64, par.glwe_dim * par.poly_size
        ct = rand_i64(g, (M, kN + 1), dev)
        tables = torch.randint(-2 ** 11, 2 ** 11, (M, 2 ** par.message_bits),
                               generator=g, device=dev, dtype=torch.int32)
        K.reset_launch_counts()
        got, secs = common.timed(lambda: P.bootstrap(
            ct, tables, dsk, par, par.delta_log2), dev)
        counts = K.launch_counts()
        for name in KERNELS:
            launches[name] += counts[name]
        want, plain_s = common.timed(lambda: P.bootstrap(
            ct, tables, dsk, par, par.delta_log2, engine="plain"), dev)
        same = torch.equal(got, want)
        print(f"  preset {preset} (n={par.lwe_dim}, N={par.poly_size}, "
              f"keyswitch 2^{par.ks_base_log} x {par.ks_levels}): bootstrap "
              f"M={M} kernel engine {secs:.2f} s, plain {plain_s:.2f} s, "
              f"{'equal' if same else 'DIFFERENT'}; launches {counts}",
              flush=True)
        if not same:
            raise AssertionError(f"preset {preset}: kernel engine != plain "
                                 "engine")
        if any(counts[k] != par.lwe_dim for k in FUSED_KERNELS):
            raise AssertionError(f"preset {preset}: launches {counts}")
        del dsk, ct, got, want
        torch.cuda.empty_cache()
    return launches


def phase_imagenet_row(dev):
    """Phase 11c: ResNet18qat at the ImageNet row compiled on the card
    picks preset 7; simulate on the card equals the CPU's."""
    from dct_cryptonets_tpu_torch.data.codec import CodecConfig, make_ingest
    from dct_cryptonets_tpu_torch.data.pipeline import load_synthetic
    from dct_cryptonets_tpu_torch.fhe.circuit import Tlu, simulate
    from dct_cryptonets_tpu_torch.fhe.runtime import compile_qat_model
    from dct_cryptonets_tpu_torch.homomorphic_eval import (
        calibrate_random_init)
    from dct_cryptonets_tpu_torch.models.resnet import build_spec, init_model

    cfg = CodecConfig(channels=64, filter_size=8, image_size_dct=56)
    spec = build_spec("ResNet18qat", in_channels=64, img_size=56,
                      num_classes=10, bit_width=5)
    t = time.time()
    ingest = make_ingest(cfg, dev)
    calib = ingest(load_synthetic(64, cfg.pixel_size, 10, seed=0).images)
    x = ingest(load_synthetic(2, cfg.pixel_size, 10, seed=1).images)
    params, state = calibrate_random_init(
        *init_model(spec, torch.Generator().manual_seed(0)), calib, spec)
    m = compile_qat_model(params, state, spec, n_bits=5,
                          rounding_threshold_bits=7, calib_data=calib,
                          device=dev)
    tlus = [op for op in m.circuit.ops if isinstance(op, Tlu)]
    max_r = max(op.spec.in_bits for op in tlus)
    print(f"  ImageNet row compiled on the card in {time.time() - t:.1f} s: "
          f"{m.circuit.num_pbs} main PBS over {len(tlus)} TLUs, max TLU "
          f"bits {max_r}, max acc bits {m.maximum_integer_bit_width()}; "
          f"main {m.params}", flush=True)
    if (m.params.message_bits, m.params.lwe_dim, m.params.poly_size) != (
            7, 970, 4096) or m.circuit.num_pbs != IMAGENET_PBS:
        raise AssertionError("the ImageNet row should run preset 7 "
                             f"(n=970, N=4096) with {IMAGENET_PBS} PBS")
    t = time.time()
    card_sim = m.forward(x.cpu().numpy(), fhe="simulate")
    card_s = time.time() - t
    t = time.time()
    cpu_sim = simulate(m.circuit, x.cpu()).numpy()
    same = np.array_equal(card_sim, cpu_sim)
    print(f"  simulate on 2 images: card {card_s:.1f} s, CPU "
          f"{time.time() - t:.1f} s, {'equal' if same else 'DIFFERENT'} "
          f"(features {card_sim.shape}, finite "
          f"{bool(np.isfinite(card_sim).all())})", flush=True)
    if not same or card_sim.shape != (2, 512):
        raise AssertionError("the card's simulate differs from the CPU's")


def main():
    with Phase("0 device"):
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device; this smoke needs one GPU",
                  file=sys.stderr)
            return 2
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True)
        card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
            else "nvidia-smi unavailable"
        print(card, flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = torch.device("cuda")
        print(f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"{torch.cuda.get_device_name(0)}", flush=True)

    with Phase("1 build"):
        from concurrent.futures import ThreadPoolExecutor

        from dct_cryptonets_tpu_torch.data import native as NATIVE
        with ThreadPoolExecutor(1) as pool:
            codec = pool.submit(NATIVE.library_path)
            secs = K.build_kernels()
            print(f"kernel build: {secs:.1f} s; native host codec: "
                  f"{codec.result()}", flush=True)
        for line in K.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print("  " + line.strip(), flush=True)

    record = {name: {} for name in KERNELS}
    record["rotate_decompose sample-major"] = {}
    with Phase("2 kernels vs plain"):
        errs = phase_kernels(dev, record)
    with Phase("3 keygen + production PBS batch"):
        s = prepare_slice(dev)
        phase_pbs(s.module, dev)
    with Phase("4 s2d engine, profile"):
        s2d_launches = phase_s2d(s.module, dev, card)
    with Phase("5 flagship image (mesh path)"):
        launches, image_s = phase_slice(s, dev)
    with Phase("6 audited flagship image"):
        audited_launches, _ = phase_audited(s, dev)
    with Phase("7 train on the card"):
        K.reset_launch_counts()
        phase_train(dev)
        train_launches = K.launch_counts()
        print(f"  kernel launches in phase 7: {train_launches}", flush=True)

    have_pil = importlib.util.find_spec("PIL") is not None
    with Phase("8 datasets, transforms, native codec"):
        K.reset_launch_counts()
        phase_data(dev, card, have_pil)
        data_launches = K.launch_counts()
        print(f"  kernel launches in phase 8: {data_launches}", flush=True)
        if any(data_launches.values()):
            raise AssertionError("phase 8 launched a CMUX kernel")
    with Phase("9 sharded paths"):
        sharded_launches = phase_sharded(s, dev, image_s)
    with Phase("10 strip table"):
        table_launches = phase_strip_table(s.module, dev, record)
    with Phase("11 larger lattices, ResNet-18"):
        large_errs = phase_large_kernels(dev, record)
        large_launches = phase_large_bootstraps(dev)
        phase_imagenet_row(dev)
    errs = {k: max(v, large_errs[k]) for k, v in errs.items()}

    def timing(name, lat):
        ms, plain, lib, M, drop, cross, *steps = record[name][lat]
        J, N, rows, _ = LATTICES[lat.split()[0]]
        b, by = bound(name, J, N, rows, M, drop, cross, *steps)
        return {"M": M, "drop": drop, "cross": cross, "ms": ms,
                "plain_ms": plain, "bound_ms": b, "bound_by": by,
                "library_ms": lib, **({"steps": steps[0]} if steps else {})}

    kernels = []
    for name, (src, replaces) in KERNELS.items():
        by_path = {"image on the mesh path, drop_policy none":
                   launches[name],
                   "image, drop_policy audit": audited_launches[name],
                   "s2d chunks": s2d_launches[name],
                   "training, compile and simulate": train_launches[name],
                   "datasets, transforms, native codec": data_launches[name],
                   "two ranks on one card, sharded chunks":
                       sharded_launches[name],
                   "strip table: build and table-fed chunk":
                       table_launches[name],
                   "presets 7 and 8 bootstrap chunks": large_launches[name]}
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": replaces, "launches": sum(by_path.values()),
                 "launches_by_path": by_path,
                 "max_abs_err": errs[name], **timing(name, "main"),
                 "aux": timing(name, "aux")}
        for lat in record[name]:
            if lat not in ("main", "aux"):
                entry[lat] = timing(name, lat)
        if name == "rotate_diff":
            entry["note"] = ("no caller in either package: launched only "
                             "against its plain version in phase 2")
        kernels.append(entry)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
