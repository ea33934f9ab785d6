"""Homomorphic evaluation entry point, counterpart of
``dct_cryptonets_tpu.homomorphic_eval`` with the same flags (the port's
``config.parse_args``, plus ``--device``) and the same flow: load the
checkpoint -> compile the QAT *trunk* to a TFHE circuit with calibration
(the classifier stays clear) -> feasibility check -> keygen -> clear eval
-> simulate eval -> execute eval -> reliability sweep.

Run (simulate, synthetic data, the committed flagship checkpoint):
  python -m dct_cryptonets_tpu_torch.homomorphic_eval --dataset synthetic \
      --dct_status --model ResNet20qat --channels 24 --filter_size 4 \
      --image_size_dct 16 --checkpoint_path \
      checkpoints/digits_flagship/best.tar --test_subset 16 \
      --fhe_mode simulate

It runs on the GPU; ``--device cpu`` runs the plain versions on the CPU.

``--drop_policy audit`` runs the exact-rounding extraction at the knobs the
circuit noise audit picks under ``--p_error`` (the extraction lattice's
(drop, cross), its truncated keyswitches, ``keep_low``), and the main
bootstraps at ``--drop_limbs`` (default 0: every key limb), as the JAX
driver does; ``--dump_circuit`` appends the audit's summary to the
listing.  The audit's own per-layer main knobs (``drop_limbs=None`` in
``CompiledModule.forward``) realize more TLU slips than ``--p_error`` on
the flagship image (PERF.md), so the driver does not run them.
The encrypted image on the card, with the realized-slip audit:
  python -m dct_cryptonets_tpu_torch.homomorphic_eval --dataset synthetic \
      --dct_status --model ResNet20qat --channels 24 --filter_size 4 \
      --image_size_dct 16 --checkpoint_path \
      checkpoints/digits_flagship/best.tar --test_subset 1 \
      --drop_policy audit --fhe_mode execute --slip_audit

Without ``--checkpoint_path`` the model is drawn at random (seed 0),
calibrated and given one train-mode forward for its BatchNorm statistics,
as the JAX package's CLI does.  A model without "qat" in its name (ResNet20,
ResNet18) is compiled by post-training quantization
(``compile_ptq_model``).  ``--dataset cifar10`` (the default) reads the
python-pickle batches under ``--dataset_path``; ImageNet, Imagenette and
miniImagenet read ImageFolder splits.  ``--profile_dir DIR`` writes a
``torch.profiler`` trace of the run into DIR.  ``--mesh N`` (execute)
shards each ciphertext batch over an N-entry mesh after keygen
(``parallel.data_mesh``: the visible GPUs in turn, or the CPU under
``--device cpu``), keys replicated (``CompiledModule.shard_over``).
"""
import json
import os
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from .checkpoint import load_ckpt
from .config import parse_args
from .data import pipeline
from .data.codec import CodecConfig, make_ingest
from .fhe.runtime import (CompiledModule, compile_ptq_model,
                          compile_qat_model, default_device)
from .parallel import data_mesh
from .models.resnet import (ModelSpec, QATResNet, build_spec,
                            calibrate_scales, init_model, model_summary)
from .utils import AverageMeter, run_profiled, topk_accuracy


@torch.no_grad()
def calibrate_random_init(params, state, x, spec: ModelSpec):
    """The CLI's random-weight model: activation scales calibrated on
    ``x``, then one train-mode forward on ``x`` for the BatchNorm running
    statistics.  Returns (params, state)."""
    params = calibrate_scales(params, state, x, spec)
    model = QATResNet(params, state, spec).to(x.device).train()
    model(x)
    return params, model.to_params()[1]


@torch.no_grad()
def test_unencrypted(model, ingest, ds, idx, batch):
    top1, top5 = AverageMeter(), AverageMeter()
    for images, labels in pipeline.batches(ds, idx, batch, shuffle=False,
                                           drop_remainder=False):
        _, logits = model(ingest(images))
        p1, p5 = topk_accuracy(logits.cpu().numpy(), labels)
        top1.update(p1, len(labels))
        top5.update(p5, len(labels))
    return top1, top5


def test_encrypted(module, clf_w, clf_b, ingest, ds, idx, batch, fhe_mode,
                   drop_limbs=0, mesh=None, resume=None, check_ref=False):
    """Encrypted-trunk + clear-classifier eval.  ``mesh``: the device mesh
    the ciphertext batch shards over (after ``module.shard_over(mesh)``);
    ``resume``: optional :class:`SweepState`; ``check_ref``: the per-TLU
    slip audit."""
    top1, top5 = AverageMeter(), AverageMeter()
    for bi, (images, labels) in enumerate(pipeline.batches(
            ds, idx, batch, shuffle=False, drop_remainder=False)):
        if resume is not None and resume.has(bi):
            p1, p5, n = resume.get(bi)
            top1.update(p1, n)
            top5.update(p5, n)
            continue
        x = ingest(images).cpu().numpy()
        feats = module.forward(x, fhe=fhe_mode, drop_limbs=drop_limbs,
                               mesh=mesh, check_ref=check_ref)
        p1, p5 = topk_accuracy(feats @ clf_w + clf_b, labels)
        top1.update(p1, len(labels))
        top5.update(p5, len(labels))
        if resume is not None:
            resume.record(bi, p1, p5, len(labels))
    return top1, top5


class SweepState:
    """Checkpoint/resume for long execute sweeps: per-batch accuracy records
    as JSONL keyed by a config tag; a mismatched tag starts fresh."""

    def __init__(self, path: str, tag: str):
        self.path = path
        self.tag = tag
        self.done: dict = {}
        if os.path.exists(path):
            with open(path) as fh:
                for line in fh:
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    if rec.get("tag") == tag:
                        self.done[rec["batch"]] = (rec["top1"], rec["top5"],
                                                   rec["n"])

    def has(self, bi: int) -> bool:
        return bi in self.done

    def get(self, bi: int):
        return self.done[bi]

    def record(self, bi: int, p1: float, p5: float, n: int):
        self.done[bi] = (p1, p5, n)
        with open(self.path, "a") as fh:
            fh.write(json.dumps({"tag": self.tag, "batch": bi, "top1": p1,
                                 "top5": p5, "n": n}) + "\n")


@dataclass
class Session:
    """Everything the eval flow builds before it evaluates."""
    spec: ModelSpec
    ingest: object
    trainset: pipeline.ArrayDataset
    testset: pipeline.ArrayDataset
    val_idx: np.ndarray
    test_idx: np.ndarray
    params: dict
    state: dict
    model: QATResNet
    module: CompiledModule


def prepare(cfg, device=None) -> Session:
    """Datasets, checkpoint, clear model and compiled module for ``cfg``
    (the flags of ``parse_args("homomorphic_eval")``) on ``device``
    (default ``cfg.device``: CUDA unless ``--device cpu``)."""
    device = torch.device(device or cfg.device)
    if device.type == "cuda":
        device = default_device()        # raises without a GPU
    img = cfg.image_size_dct if cfg.dct_status else cfg.image_size
    in_ch = cfg.channels if cfg.dct_status else 3
    spec = build_spec(cfg.model, in_channels=in_ch, img_size=img,
                      num_classes=cfg.num_classes, bit_width=cfg.bit_width)
    codec_cfg = CodecConfig(cfg.channels, cfg.filter_size, cfg.image_size_dct,
                            cfg.dct_pattern) if cfg.dct_status else None
    ingest = make_ingest(codec_cfg, device, cfg.image_size, cfg.dataset)

    pix = codec_cfg.pixel_size if codec_cfg else cfg.image_size
    trainset = pipeline.get_dataset(cfg.dataset, cfg.dataset_path, True,
                                    image_size=pix,
                                    num_classes=cfg.num_classes)
    testset = pipeline.get_dataset(cfg.dataset, cfg.dataset_path, False,
                                   image_size=pix,
                                   num_classes=cfg.num_classes)
    # seeded subset selection (reference homomorphic_eval.py:145-150)
    _, val_idx = pipeline.train_val_split(len(trainset), cfg.test_subset)
    _, test_idx = pipeline.train_val_split(
        len(testset), min(cfg.test_subset, len(testset) - 1))

    # the first calibration batch drives the scales of a random model
    # and the compiler's accumulator ranges
    calib_imgs = trainset.gather(
        np.arange(min(cfg.calib_batch_size, len(trainset))))[0]
    calib_x = ingest(calib_imgs)
    if cfg.checkpoint_path and os.path.exists(cfg.checkpoint_path):
        ck = load_ckpt(cfg.checkpoint_path)
        params, state = ck["state"]
        print(f"Loaded checkpoint {cfg.checkpoint_path} "
              f"({ck['prec1']:.3f}% Top-1 @ epoch {ck['epoch']})")
    else:
        print("WARNING: No checkpoint loaded. Using random weights "
              "(for testing only)")
        params, state = calibrate_random_init(
            *init_model(spec, torch.Generator().manual_seed(0)), calib_x,
            spec)
    print("\n" + model_summary(spec, params))
    model = QATResNet(params, state, spec).to(device).eval()

    quantization_type = "QAT" if spec.quantized else "PTQ"
    print(f"\nCompiling FHE Model ({quantization_type})...")
    t = time.time()
    if spec.quantized:
        module = compile_qat_model(
            params, state, spec, n_bits=cfg.n_bits,
            rounding_threshold_bits={"n_bits": cfg.rounding_threshold_bits,
                                     "method": cfg.rounding_method},
            calib_data=calib_x, pbs_batch=cfg.pbs_batch,
            drop_policy=cfg.drop_policy, p_error=cfg.p_error,
            range_margin=cfg.range_margin, residual_mode=cfg.residual_mode,
            device=device)
    else:
        module = compile_ptq_model(
            params, state, spec, calib_x, n_bits=cfg.n_bits,
            rounding_threshold_bits=cfg.rounding_threshold_bits,
            pbs_batch=cfg.pbs_batch, device=device)
    print(f"Time for FHE compilation {time.time()-t:.2f}")
    return Session(spec, ingest, trainset, testset, val_idx, test_idx,
                   params, state, model, module)


def main(argv=None):
    return run_profiled(parse_args("homomorphic_eval", argv), main_impl)


def main_impl(cfg):
    s = prepare(cfg)
    module = s.module

    bitwidth = module.maximum_integer_bit_width()
    print(f"Max bit-width: {bitwidth} bits" +
          (" -> it works in FHE!!" if bitwidth <= 16
           else " too high for FHE computation"))
    print(f"PBS per image: {module.circuit.num_pbs}")
    if cfg.dump_circuit:
        text = module.circuit.dump()
        if cfg.drop_policy == "audit":
            text += "\n\n" + module.run_audit().summary()
        with open(cfg.dump_circuit, "w") as fh:
            fh.write(text + "\n")
        print(f"Circuit dumped to {cfg.dump_circuit}")

    mesh = None
    if cfg.fhe_mode == "execute":
        t = time.time()
        module.keygen()
        print(f"Keygen time: {time.time()-t:.2f}s")
        if cfg.mesh:
            mesh = data_mesh(int(cfg.mesh), devices=module.device
                             if module.device.type == "cpu" else None)
            module.shard_over(mesh)
            print(f"Sharded encrypted eval over {mesh.size} device(s) "
                  "(keys replicated, ciphertext batch sharded)")

    clf_w = np.asarray(s.params["classifier"]["w"])
    clf_b = np.asarray(s.params["classifier"]["b"])

    print(f"\nRunning UNENCRYPTED model on a subset of {cfg.test_subset} "
          "images...")
    v1, v5 = test_unencrypted(s.model, s.ingest, s.trainset, s.val_idx,
                              cfg.calib_batch_size)
    t1, t5 = test_unencrypted(s.model, s.ingest, s.testset, s.test_idx,
                              cfg.calib_batch_size)
    print(f"[Validation] Top-1 Acc: {v1.avg:.3f}% | Top-5 Acc: {v5.avg:.3f}%")
    print(f"[Test] Top-1 Acc: {t1.avg:.3f}% | Top-5 Acc: {t5.avg:.3f}%")

    if cfg.fhe_mode == "simulate":
        t = time.time()
        print("\nRunning ENCRYPTED validation inference in SIMULATE mode...")
        e1, e5 = test_encrypted(module, clf_w, clf_b, s.ingest, s.trainset,
                                s.val_idx, cfg.calib_batch_size, "simulate")
        dt = (time.time() - t) / max(len(s.val_idx), 1)
        print(f"[Validation] Top-1 Acc: {e1.avg:.3f}% | Top-5 Acc: "
              f"{e5.avg:.3f}% | Time per inference: {dt:.3f}")

    resume = None
    if cfg.fhe_mode == "execute" and cfg.sweep_state:
        p = module.params
        tag = (f"{cfg.model}|{cfg.checkpoint_path}|{cfg.dataset}|"
               f"r{cfg.rounding_threshold_bits}|n{cfg.n_bits}|"
               f"{cfg.rounding_method}|{cfg.residual_mode}|"
               f"{cfg.drop_policy}|b{cfg.test_batch_size}"
               f"|s{cfg.test_subset}|pe{cfg.p_error}"
               f"|m{cfg.range_margin}|d{cfg.drop_limbs}"
               f"|P{p.lwe_dim}.{p.glwe_dim}.{p.poly_size}")
        resume = SweepState(cfg.sweep_state, tag)
        if resume.done:
            print(f"Resuming execute sweep: {len(resume.done)} batch(es) "
                  f"already recorded in {cfg.sweep_state}")

    t = time.time()
    print(f"\nRunning ENCRYPTED test inference in {cfg.fhe_mode.upper()} mode "
          f"on a subset of {len(s.test_idx)} images...")
    e1, e5 = test_encrypted(module, clf_w, clf_b, s.ingest, s.testset,
                            s.test_idx, cfg.test_batch_size, cfg.fhe_mode,
                            cfg.drop_limbs, mesh=mesh, resume=resume,
                            check_ref=cfg.slip_audit)
    dt = (time.time() - t) / max(len(s.test_idx), 1)
    print(f"[Test] Top-1 Acc: {e1.avg:.3f}% | Top-5 Acc: {e5.avg:.3f}% | "
          f"Time per inference in FHE: {dt:.2f}")
    if cfg.fhe_mode == "execute" and module.stats.get("pbs_per_sec"):
        st = module.stats
        print(f"[Stats] execute {st['execute_time']:.1f}s | levelled "
              f"{st['levelled_time']:.1f}s | PBS "
              f"{st['pbs_time']:.1f}s ({st['pbs_per_sec']:.1f} PBS/s, "
              f"{st.get('aux_pbs_executed', 0)} extraction bootstraps) | "
              f"keygen {st.get('keygen_time', 0):.1f}s")
        if "tlu_slips" in st:
            print(f"[Slip audit] {st['tlu_slips']} realized TLU slips / "
                  f"{st['tlu_sites']} TLU sites (per-PBS p_error <= "
                  f"{module.p_error}); audit overhead "
                  f"{st.get('audit_time', 0):.1f}s (excluded from execute)")

    # reliability sweep (reference homomorphic_eval.py:366-440)
    if cfg.reliability_test and cfg.fhe_mode == "simulate":
        print("\n============ Encrypted Reliability Analysis ============")
        top1_plain, top5_plain, top1_enc, top5_enc = [], [], [], []
        for rstate in range(27, 29):
            _, sub_idx = pipeline.train_val_split(
                len(s.testset), min(cfg.test_subset, len(s.testset) - 1),
                random_state=rstate)
            p1, p5 = test_unencrypted(s.model, s.ingest, s.testset, sub_idx,
                                      cfg.calib_batch_size)
            e1, e5 = test_encrypted(module, clf_w, clf_b, s.ingest,
                                    s.testset, sub_idx, cfg.calib_batch_size,
                                    "simulate")
            top1_plain.append(round(p1.avg, 3))
            top5_plain.append(round(p5.avg, 3))
            top1_enc.append(round(e1.avg, 3))
            top5_enc.append(round(e5.avg, 3))
        print(f"Unencrypted top1 acc: {top1_plain}")
        print(f"Unencrypted top5 acc: {top5_plain}")
        print(f"Encrypted top1 acc: {top1_enc}")
        print(f"Encrypted top5 acc: {top5_enc}")
    print("Done")


if __name__ == "__main__":
    try:
        main()
    except KeyboardInterrupt:
        print("Interrupted")
        sys.exit(130)
