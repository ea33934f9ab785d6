#!/usr/bin/env python3
"""Accuracy parity of the requant-elided (fused) circuit on a trained
model, counterpart of the JAX package's ``tools/digits_fused_parity.py``.

    python3 dct_cryptonets_tpu_torch/tools/digits_fused_parity.py \
        [--epochs 30] [--cpu]

Trains the flagship topology (ResNet20qat, DCT 24x16^2) on the digits with
this package's trainer (the JAX tool's flags: batch 32, Adam 1e-3,
augmentation on; on the GPU unless ``--cpu``), into
``build/digits_fused_parity/``, then compares the clear QAT model's test
top-1 with the integer simulator's in both residual modes (calibration on
the first 64 training images, threshold 6) and prints the JAX tool's
``PARITY:`` line.  The elided circuit keeps full accumulator resolution
into the residual adds, so its accuracy should be at parity or better
with the reference-literal requant circuit.
"""
import argparse
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

CKPT_DIR = os.path.join(ROOT, "build", "digits_fused_parity")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    from dct_cryptonets_tpu_torch import train as tr
    from dct_cryptonets_tpu_torch.checkpoint import load_ckpt
    from dct_cryptonets_tpu_torch.data import CodecConfig, dct_ingest
    from dct_cryptonets_tpu_torch.data.pipeline import load_digits_dataset
    from dct_cryptonets_tpu_torch.fhe.circuit import simulate
    from dct_cryptonets_tpu_torch.fhe.compiler import lower
    from dct_cryptonets_tpu_torch.fhe.runtime import default_device
    from dct_cryptonets_tpu_torch.models.resnet import QATResNet, build_spec

    dev = torch.device("cpu") if args.cpu else default_device()
    t0 = time.time()
    argv = ["--dataset", "digits", "--dct_status", "--model", "ResNet20qat",
            "--channels", "24", "--filter_size", "4", "--image_size_dct",
            "16", "--bit_width", "4", "--batch_size", "32", "--lr", "1e-3",
            "--stop_epoch", str(args.epochs), "--train_aug",
            "--checkpoint_dir", CKPT_DIR, "--device", dev.type]
    tr.main(argv)
    print(f"# training took {time.time()-t0:.0f}s")

    ck = load_ckpt(os.path.join(CKPT_DIR, "best.tar"))
    params, state = ck["state"]
    spec = build_spec("ResNet20qat", in_channels=24, img_size=16,
                      num_classes=10, bit_width=4)

    cfg = CodecConfig(channels=24, filter_size=4, image_size_dct=16)
    test = load_digits_dataset(train=False, image_size=32)
    trainset = load_digits_dataset(train=True, image_size=32)
    x_te = dct_ingest(torch.as_tensor(test.images, device=dev), cfg)
    x_cal = dct_ingest(torch.as_tensor(trainset.images[:64], device=dev), cfg)
    clf_w = np.asarray(params["classifier"]["w"])
    clf_b = np.asarray(params["classifier"]["b"])

    def acc(logits):
        return float((np.argmax(logits, -1) == test.labels).mean() * 100)

    with torch.no_grad():
        _, logits_clear = QATResNet(params, state, spec).to(dev)(x_te)
    a_clear = acc(logits_clear.cpu().numpy())
    out = {"clear_qat": a_clear}
    for mode in ("requant", "fused"):
        circ = lower(params, state, spec, rounding_threshold_bits=6,
                     calib_data=x_cal, residual_mode=mode)
        feats = simulate(circ, x_te).cpu().numpy()
        a = acc(feats @ clf_w + clf_b)
        out[mode] = a
        out[f"{mode}_pbs"] = circ.num_pbs
        out[f"{mode}_maxbits"] = circ.max_bit_width()
    print("PARITY:", out)


if __name__ == "__main__":
    main()
