#!/usr/bin/env python3
"""The trainer's rate: steps per s of the flagship digits recipe (the
recipe of ``checkpoints/digits_flagship``: digits, DCT 24x16^2,
ResNet20qat, augmentation on, batch 128, Adam 1e-3), run through
``train.main``.

    python3 dct_cryptonets_tpu_torch/tools/train_rate.py [--tree DIR] \
        [--epochs 30] [--cpu]

``--tree DIR`` imports the trainer from the checkout at DIR instead of
this one, so that two trees' trainers are timed on one card in one call
(in turns: A, B, B, A, one process each).  Checkpoints go to
``build/train_rate/``.  Prints the card's name and power limit, then
``TRAIN_RATE: {...}``: the steps, epochs and training seconds, steps per
s over all epochs and after the first, best val top-1 and clear test
top-1 (%).
"""
import argparse
import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

RECIPE = ["--dataset", "digits", "--dct_status", "--train_aug", "--model",
          "ResNet20qat", "--channels", "24", "--filter_size", "4",
          "--image_size_dct", "16", "--batch_size", "128",
          "--test_batch_size", "256", "--lr", "0.001", "--optimizer", "adam"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=ROOT,
                    help="the checkout whose trainer runs")
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    from benchmark.common import card_line
    from dct_cryptonets_tpu_torch import train

    ckdir = os.path.join(ROOT, "build", "train_rate")
    shutil.rmtree(ckdir, ignore_errors=True)
    res = train.main(RECIPE + ["--stop_epoch", str(args.epochs),
                               "--checkpoint_dir", ckdir, "--device",
                               "cpu" if args.cpu else "cuda"])
    ep = res["epoch_s"]
    per_epoch = res["steps"] / res["epochs"]
    print(card_line())
    print("TRAIN_RATE: " + json.dumps({
        "tree": tree, "steps": res["steps"], "epochs": res["epochs"],
        "train_s": sum(ep), "steps_per_s": res["steps"] / sum(ep),
        "steps_per_s_after_first": per_epoch * (len(ep) - 1) / sum(ep[1:])
        if len(ep) > 1 else None,
        "best_val": res["best_val"], "test_top1": res["test_top1"]}),
        flush=True)


if __name__ == "__main__":
    main()
