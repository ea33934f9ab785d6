#!/usr/bin/env python3
"""Sweep the fused engine's knobs on the card, counterpart of the JAX
package's ``tools/tune_fused.py``.

    python3 dct_cryptonets_tpu_torch/tools/tune_fused.py aux  [M]   # M=4096
    python3 dct_cryptonets_tpu_torch/tools/tune_fused.py main [M]   # M=2048

Times one full blind rotate of M random accumulators (kernel engine) on
either lattice at the JAX tool's knobs: the extraction preset (k2n512f)
at drop 3, cross 0, or the main lattice (preset 6) at drop 2, cross 1,
under the JAX tool's keys (client keys from seed 0; the aux keys from
seed 2, the main server keys from seed 1).  The knobs swept are the ones
this card has:

* K3's row tile (``csrc/fused_external.cu`` picks 128 or 64 rows by
  waves): ``auto`` as committed, or forced to 64 or 128 rows in a build
  variant under ``build/tune_fused/`` (the committed source is not
  touched);
* on aux, the precomputed strip table (``pbs.precompute_bigd_strips``:
  one K2 launch over every step's key rows, each step's slice fed to K3)
  against each step's own strips; its build time and bytes are printed.

Env: ``TUNE_CONFIGS="tile[:pre],..."`` (tile: auto, 64 or 128) overrides
the sweep.  Every configuration's output is held to the first's, bit for
bit.  Needs one NVIDIA GPU and nvcc.
"""
import os
import shutil
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark.common import card_line, timed  # noqa: E402
from dct_cryptonets_tpu_torch.fhe import kernels as K  # noqa: E402
from dct_cryptonets_tpu_torch.fhe import pbs as P  # noqa: E402
from dct_cryptonets_tpu_torch.fhe import torus as T  # noqa: E402

TILE = "  const int mw = w128 <= w64 ? 2 : 1;"
TILES = {"auto": None, "64": "  const int mw = 1; (void)w128; (void)w64;",
         "128": "  const int mw = 2; (void)w128; (void)w64;"}
BUILD = os.path.join(ROOT, "build", "tune_fused")
CSRC, BUILD_ROOT = K.CSRC_DIR, K.BUILD_ROOT       # the committed build


def build(tile):
    """The kernel library with K3's row tile forced (``auto``: the
    committed sources); returns its ctypes handle."""
    if TILES[tile] is None:
        K._lib = None
        K.CSRC_DIR, K.BUILD_ROOT = CSRC, BUILD_ROOT
        K.build_kernels()
        return K._lib
    src = os.path.join(BUILD, f"tile{tile}", "csrc")
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(CSRC, src)
    path = os.path.join(src, "fused_external.cu")
    with open(path) as fh:
        text = fh.read()
    if TILE not in text:
        raise RuntimeError(f"the K3 source no longer has {TILE!r}")
    with open(path, "w") as fh:
        fh.write(text.replace(TILE, TILES[tile]))
    K._lib = None
    K.CSRC_DIR, K.BUILD_ROOT = src, os.path.join(os.path.dirname(src), "cuda")
    K.build_kernels()
    return K._lib


def lattice_keys(which):
    """(params, bsk byte limbs on the card, M default, drop, cross)."""
    from dct_cryptonets_tpu_torch.fhe.keys import (keygen,
                                                   make_aux_server_keys,
                                                   make_server_keys)
    from dct_cryptonets_tpu_torch.fhe.params import (default_exact_rounding,
                                                     params_for_precision)

    main_params = params_for_precision(6)
    ck = keygen(main_params, seed=0)
    t = time.time()
    if which == "aux":
        cfg = default_exact_rounding(main_params)
        bsk = make_aux_server_keys(ck, cfg.aux, seed=2,
                                   back_base_log=cfg.back_base_log,
                                   back_levels=cfg.back_levels).bsk
        p, M, drop, cross = cfg.aux, 4096, 3, 0
    else:
        bsk = make_server_keys(ck, seed=1).bsk
        p, M, drop, cross = main_params, 2048, 2, 1
    print(f"# keygen {time.time() - t:.1f}s", file=sys.stderr, flush=True)
    return p, P._doubled_bytes(bsk), M, drop, cross


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    which = argv[0] if argv else "aux"
    if not torch.cuda.is_available():
        print("tune_fused: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(card_line(), flush=True)
    p, bsk_np, M, drop, cross = lattice_keys(which)
    M = int(argv[1]) if len(argv) > 1 else M
    bsk_bytes = torch.from_numpy(bsk_np).to(dev)
    k, N, n, levels = p.glwe_dim, p.poly_size, p.lwe_dim, p.pbs_levels
    rng = np.random.default_rng(5)
    test = T.from_u64(rng.integers(0, 1 << 63, (M, N)).astype(np.uint64),
                      dev)
    ct_a = torch.as_tensor(rng.integers(0, 2 * N, (M, n)), device=dev)
    ct_b = torch.as_tensor(rng.integers(0, 2 * N, (M,)), device=dev)
    print(f"# {which}: n={n} k={k} N={N} M={M} drop={drop} cross={cross}",
          flush=True)

    env = os.environ.get("TUNE_CONFIGS")
    if env:
        configs = [(f.split(":")[0], f.endswith(":pre"))
                   for f in env.split(",")]
    elif which == "aux":
        configs = [("auto", False), ("auto", True), ("64", False),
                   ("64", True), ("128", False), ("128", True)]
    else:
        configs = [("auto", False), ("64", False), ("128", False)]
    libs = {tile: build(tile) for tile in dict.fromkeys(t for t, _ in configs)}

    table = None
    if any(pre for _, pre in configs):
        K._lib = libs[configs[0][0]]
        table, pre_s = timed(lambda: P.precompute_bigd_strips(
            bsk_bytes, k, levels, N, drop), dev)
        print(f"# strip table: {tuple(table.shape)}, "
              f"{table.numel() / 1e9:.3f} GB, built in {pre_s:.3f}s "
              f"(one K2 launch over {n * (k + 1)} key rows)", flush=True)

    def br(test, bigd_all):
        return P.blind_rotate(test, ct_a, ct_b, bsk_bytes, p, drop, cross,
                              engine="kernel", bigd_all=bigd_all)

    first = None
    for tile, pre in configs:
        K._lib = libs[tile]
        bigd_all = table if pre else None
        out, first_s = timed(lambda: br(test, bigd_all), dev)
        if first is None:
            first = out
        elif not torch.equal(out, first):
            raise AssertionError(f"tile={tile} pre={int(pre)} differs from "
                                 "the first configuration")
        iters = 3
        t0 = time.time()
        cur = test
        for _ in range(iters):
            cur = br(cur, bigd_all)[:, 0]      # chain: vary the input
        torch.cuda.synchronize()
        dt = (time.time() - t0) / iters
        print(f"tile={tile} pre={int(pre)}: {dt:.3f}s per {M}-rotate batch "
              f"-> {M / dt:.1f}/s (first {first_s:.1f}s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
