"""Training entry point, counterpart of ``dct_cryptonets_tpu.train`` (the
reference trainer's behavior, reference train.py:31-421): config-derived
checkpoint dirs, adam/adamw/sgd with optax's semantics, a step-decay
schedule, gradient clipping, per-epoch validation, periodic and best
checkpoints, a JSONL log, early stopping and a final test of the best
model.

The model is ``models.resnet.QATResNet`` in train mode; the ingest
(augmentation and DCT) runs on the batch's device.  Convolutions run in
full float32 in the forward and the backward.  On the GPU the run takes
deterministic algorithms only (:func:`reproducible`), so one seed gives
one set of weights, as the JAX trainer on XLA does.  Checkpoints are
pickles of numpy pytrees with the JAX trainer's payload keys, so either
package reads the other's weights; the optimizer state resumes only in
the package that wrote it.

Run (the flagship recipe; on the GPU unless ``--device cpu``):
  python -m dct_cryptonets_tpu_torch.train --dataset digits --dct_status \\
      --train_aug --model ResNet20qat --channels 24 --filter_size 4 \\
      --image_size_dct 16 --batch_size 128 --test_batch_size 256 \\
      --lr 0.001 --optimizer adam --stop_epoch 30

``--profile_dir DIR`` writes a ``torch.profiler`` trace of the run into
DIR.  The RGB path writes ``example_images.png`` and the cifar10,
Imagenette and synthetic sets ``heatmap.png`` into the checkpoint
directory (``viz.py``), where the JAX trainer plots them.

``--mesh N`` trains data-parallel over N processes, one per mesh entry
(``parallel.data_mesh``: the visible GPUs in turn, or the CPU under
``--device cpu``), joined by ``torch.distributed`` (NCCL when each has a
GPU of its own, gloo otherwise, as two processes on one GPU).  Each
process takes its rows of every batch; the augmentation and dropout
draws are the whole batch's, sliced; the BatchNorm statistics, the loss,
top-k and the gradient are the whole batch's (all-reduced), so every
process holds the same parameters and optimizer state.  Validation,
checkpoints and prints are rank 0's.
"""
import json
import os
import sys
import time
from contextlib import contextmanager

import numpy as np
import torch
import torch.distributed as dist

from .checkpoint import (load_ckpt, optimizer_state_from_numpy,
                         optimizer_state_to_numpy, save_ckpt)
from .config import checkpoint_dir_for, parse_args
from .data import pipeline
from .data.codec import CodecConfig, dct_ingest_train, rgb_ingest_train
from .data.codec import make_ingest as make_eval_ingest
from .fhe.runtime import default_device
from .ops.quant import true_div
from .parallel import data_mesh, global_data_mesh, initialize
from .parallel.distributed import (all_gather, all_reduce, broadcast,
                                   coll_device, free_port, shutdown)
from .parallel.mesh import shard_rows
from .models.resnet import (QATResNet, build_spec, calibrate_scales,
                            init_model, model_summary, train_convolutions,
                            tree_leaves)
from .utils import (AverageMeter, EarlyStopper, run_profiled, step_decay_lr,
                    topk_accuracy)


def make_optimizer(cfg, lr, params) -> torch.optim.Optimizer:
    """The JAX trainer's optax chain as a ``torch.optim`` optimizer: Adam
    with ``weight_decay`` as an L2 term on the gradient, AdamW with
    decoupled decay, SGD with momentum and no decay.  Clipping comes first
    and is :func:`clip_gradients`' job."""
    params = list(params)
    if cfg.optimizer == "adam":
        return torch.optim.Adam(params, lr=lr,
                                weight_decay=cfg.weight_decay or 0.0)
    if cfg.optimizer == "adamw":
        return torch.optim.AdamW(params, lr=lr,
                                 weight_decay=cfg.weight_decay)
    return torch.optim.SGD(params, lr=lr, momentum=cfg.momentum)


@torch.no_grad()
def clip_gradients(params, cfg):
    """optax ``clip`` (an elementwise clamp) when ``grad_clip_value`` is
    set, else ``clip_by_global_norm``: every gradient times
    ``max_norm / norm`` when the global norm reaches ``max_norm``."""
    grads = [p.grad for p in params if p.grad is not None]
    if cfg.grad_clip_value is not None:
        for g in grads:
            g.clamp_(-cfg.grad_clip_value, cfg.grad_clip_value)
    elif cfg.grad_clip_norm is not None:
        max_norm = cfg.grad_clip_norm
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        for g in grads:
            g.copy_(torch.where(norm < max_norm, g, (g / norm) * max_norm))


def set_lr(opt: torch.optim.Optimizer, lr: float):
    for group in opt.param_groups:
        group["lr"] = lr


def cross_entropy(logits, labels):
    logp = torch.log_softmax(logits, dim=1)
    return -torch.mean(torch.gather(logp, 1, labels[:, None]))


def make_ingest(cfg, codec_cfg: CodecConfig | None, device):
    """``ingest(images, train, generator, rows)``: the train path
    (augmented when ``--train_aug``) or the codec's eval path, on
    ``device``; ``rows``: a data-parallel shard's rows of the batch (the
    augmentation draws are the whole batch's)."""
    eval_ingest = make_eval_ingest(codec_cfg, device, cfg.image_size,
                                   cfg.dataset)

    def ingest(images, train=False, generator=None, rows=None):
        if not (train and cfg.train_aug):
            return eval_ingest(images if rows is None else images[rows])
        x = torch.as_tensor(np.asarray(images), device=device)
        if codec_cfg is None:
            return rgb_ingest_train(generator, x, cfg.image_size,
                                    cfg.dataset, rows)
        return dct_ingest_train(generator, x, codec_cfg, rows)
    return ingest


def train_step(model, opt, cfg, x, labels, generator, shard=None):
    """One optimizer step on the ingested batch ``x``; returns (loss,
    logits), detached.  Dropout on the logits (reference train.py:396)
    draws its mask from ``generator``.  The convolutions run in full
    float32 with cuDNN's deterministic algorithms
    (``models.resnet.train_convolutions``).

    ``shard`` = (rows, n) in a data-parallel process group (the model's
    BatchNorm synced, :meth:`QATResNet.data_parallel`): ``x`` and
    ``labels`` are ``rows`` of a global batch of ``n``.  The dropout mask
    is drawn for the global batch and sliced, the gradients are
    all-reduced into the gradient of the global mean loss, and the loss
    and logits returned are the global batch's."""
    model.train()
    with train_convolutions():
        _, logits = model(x)
        if cfg.dropout:
            shape = logits.shape if shard is None else (shard[1],
                                                        logits.shape[1])
            keep = torch.rand(shape, generator=generator) < 1 - cfg.dropout
            if shard is not None:
                keep = keep[shard[0]]
            logits = torch.where(keep.to(logits.device),
                                 true_div(logits, 1 - cfg.dropout),
                                 torch.zeros_like(logits))
        if shard is None:
            loss = cross_entropy(logits, labels)
        else:
            logp = torch.log_softmax(logits, dim=1)
            loss = -torch.sum(torch.gather(logp, 1, labels[:, None])) \
                / shard[1]
        opt.zero_grad(set_to_none=True)
        loss.backward()
    params = [p for g in opt.param_groups for p in g["params"]]
    loss, logits = loss.detach(), logits.detach()
    if shard is not None:
        grads = [p.grad for p in params if p.grad is not None]
        flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]))
        for g, v in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(v.view_as(g))
        loss = all_reduce(loss.clone())
        logits = torch.cat(all_gather(logits))
    clip_gradients(params, cfg)
    opt.step()
    return loss, logits


@torch.no_grad()
def eval_step(model, x, labels):
    model.eval()
    _, logits = model(x)
    return cross_entropy(logits, labels), logits


def evaluate(model, ingest, ds, idx, batch, device):
    """(loss, top-1, top-5) meters and the predictions over ``idx``."""
    vl, v1, v5 = AverageMeter(), AverageMeter(), AverageMeter()
    preds = []
    for images, labels in pipeline.batches(ds, idx, batch, shuffle=False,
                                           drop_remainder=False):
        y = torch.as_tensor(labels.astype(np.int64), device=device)
        loss, logits = eval_step(model, ingest(images), y)
        logits = logits.cpu().numpy()
        p1, p5 = topk_accuracy(logits, labels)
        vl.update(float(loss), len(labels))
        v1.update(p1, len(labels))
        v5.update(p5, len(labels))
        preds.append(np.argmax(logits, 1))
    return vl, v1, v5, np.concatenate(preds) if preds else np.zeros(0)


# under deterministic algorithms PyTorch refuses a cuBLAS call unless the
# environment names one of cuBLAS's fixed workspace configurations
CUBLAS_WORKSPACE = ":4096:8"
CUBLAS_FIXED_WORKSPACES = (":4096:8", ":16:8")


@contextmanager
def reproducible(device: torch.device):
    """On a CUDA ``device``: every op under
    ``torch.use_deterministic_algorithms(True)``, which raises on an op
    that has no deterministic implementation, so one seed gives one set of
    weights.  The caller's setting comes back afterwards.  The
    convolutions' cuDNN flags are the train step's
    (``models.resnet.train_convolutions``).

    PyTorch sizes cuBLAS's workspace from ``CUBLAS_WORKSPACE_CONFIG`` at
    the process's first cuBLAS call, so the variable must hold a fixed
    configuration before that call: ``main`` sets it as a process's entry
    point; a caller of ``main_impl`` sets it before its first cuBLAS call
    (``chip_smoke.py`` before importing torch).  Raises if it does not
    hold one, since set here it could come too late to size the
    workspace."""
    if device.type != "cuda":
        yield
        return
    if os.environ.get("CUBLAS_WORKSPACE_CONFIG") not in \
            CUBLAS_FIXED_WORKSPACES:
        raise RuntimeError(
            "deterministic training on the GPU needs CUBLAS_WORKSPACE_CONFIG "
            f"set to one of {CUBLAS_FIXED_WORKSPACES} before the process's "
            "first cuBLAS call (train.main sets it)")
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])


def main(argv=None):
    # before the process's first cuBLAS call (:func:`reproducible`)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    return run_profiled(parse_args("train", argv), main_impl)


def main_impl(cfg):
    """Train as the flags say; returns a summary: ``best_val`` (top-1 %),
    ``test_top1`` (%), ``test_correct``, ``test_total``, ``epochs``,
    ``steps``, ``epoch_s`` (seconds per training epoch) and ``ckpt_dir``.
    Under ``--mesh N``: rank 0's summary of the N-process run."""
    device = torch.device(cfg.device)
    if device.type == "cuda":
        device = default_device()        # raises without a GPU
    if not cfg.mesh:
        with reproducible(device):
            return train_process(cfg, device)
    mesh = data_mesh(int(cfg.mesh), devices="cpu"
                     if device.type == "cpu" else None)
    ndev = mesh.size
    print(f"Mesh: {ndev} device(s)")
    assert cfg.batch_size % ndev == 0, \
        f"--batch_size {cfg.batch_size} must divide the {ndev}-device mesh"
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.SimpleQueue()
    torch.multiprocessing.spawn(
        _mesh_process, args=(cfg, [str(d) for d in mesh.devices],
                             f"localhost:{free_port()}", results),
        nprocs=ndev, join=True)
    return results.get()


def _mesh_process(rank, cfg, devices, address, results):
    """One process of a ``--mesh`` run: joins the group, trains its rows
    of every batch and, on rank 0, hands back the summary."""
    if torch.device(devices[rank]).type == "cpu":
        torch.set_num_threads(max(1, torch.get_num_threads() // len(devices)))
    initialize(address, len(devices), rank, devices=[devices[rank]])
    try:
        device = torch.device(devices[rank])
        with reproducible(device):
            summary = train_process(cfg, device, rank=rank,
                                    world=len(devices))
        if rank == 0:
            results.put(summary)
    finally:
        shutdown()


def train_process(cfg, device, rank=0, world=1):
    """The training run of one process: the whole run when ``world`` is
    1, else rank ``rank``'s part of a data-parallel run over ``world``
    processes of an initialized group (``main_impl`` under ``--mesh``);
    the caller runs it under :func:`reproducible`."""
    say = print if rank == 0 else (lambda *a, **k: None)
    ckpt_dir = checkpoint_dir_for(cfg)
    os.makedirs(ckpt_dir, exist_ok=True)
    say(f"Checkpoint dir: {ckpt_dir}")

    img = cfg.image_size_dct if cfg.dct_status else cfg.image_size
    in_ch = cfg.channels if cfg.dct_status else 3
    spec = build_spec(cfg.model, in_channels=in_ch, img_size=img,
                      num_classes=cfg.num_classes, bit_width=cfg.bit_width)
    codec_cfg = CodecConfig(cfg.channels, cfg.filter_size, cfg.image_size_dct,
                            cfg.dct_pattern) if cfg.dct_status else None

    # datasets and the reference's split (train_test_split, rs=42)
    pix = codec_cfg.pixel_size if codec_cfg else cfg.image_size
    trainset, testset = (pipeline.get_dataset(
        cfg.dataset, cfg.dataset_path, train, image_size=pix,
        num_classes=cfg.num_classes, synthetic_size=cfg.synthetic_size)
        for train in (True, False))
    train_idx, val_idx = pipeline.train_val_split(len(trainset), 0.1)
    say(f"Device: {device}")
    ingest = make_ingest(cfg, codec_cfg, device)

    params, state = init_model(spec, torch.Generator().manual_seed(0))
    # per-layer topology summary (reference train.py:335-347, torchinfo)
    say(model_summary(spec, params))
    if spec.quantized:
        # runtime-stats activation-scale calibration on one batch
        imgs0, _ = trainset.gather(train_idx[:64])
        params = calibrate_scales(params, state, ingest(imgs0), spec)
    n_params = sum(int(np.prod(np.shape(a))) for a in tree_leaves(params))
    say(f"Number Parameters: {n_params}")

    start_epoch = cfg.start_epoch
    best_val = 0.0
    opt_state = None
    if cfg.resume:
        ck = load_ckpt(cfg.resume)
        params, state = ck["state"]
        opt_state = ck["optimizer"]
        if not (isinstance(opt_state, dict) and "param_groups" in opt_state):
            raise ValueError(f"{cfg.resume}: its optimizer state was not "
                             "written by this package")
        # resumes AT the saved epoch, as the reference does (ROADMAP)
        start_epoch = ck["epoch"]
        best_val = ck["prec1"]
        say(f"Resumed {cfg.resume} ({best_val:.3f}% @ epoch {ck['epoch']})")

    model = QATResNet.from_params(params, state, spec).to(device)
    mesh = None
    if world > 1:
        mesh = global_data_mesh()
        model.data_parallel(dist.group.WORLD)
    opt = make_optimizer(cfg, cfg.lr, model.parameters())
    if opt_state is not None:
        opt.load_state_dict(optimizer_state_from_numpy(opt_state))
        # the JAX trainer rebuilds its optimizer at the base LR and
        # decays it again only at the next milestone (ROADMAP)
        set_lr(opt, cfg.lr)
    stopper = EarlyStopper(patience=10, threshold=0.03)
    gen = torch.Generator().manual_seed(1234)
    if not cfg.dct_status and rank == 0:
        # example-image grid (reference train.py:394-395 plots only for
        # the RGB path)
        from .viz import plot_examples
        plot_examples(ckpt_dir, trainset.gather(train_idx[:64])[0],
                      trainset.labels[train_idx[:64]], trainset.classes)

    def save(name, epoch, p1, p5):
        if rank != 0:
            return
        save_ckpt(os.path.join(ckpt_dir, name), epoch, *model.to_params(),
                  optimizer_state_to_numpy(opt.state_dict()), p1, p5)

    log_path = os.path.join(ckpt_dir, "train_log.jsonl")
    epoch_s, steps, epochs = [], 0, 0
    for epoch in range(start_epoch, cfg.stop_epoch):
        lr = step_decay_lr(cfg.lr, cfg.schedule, cfg.gamma, epoch)
        if cfg.schedule and epoch + 1 in cfg.schedule:
            # the reference resets the optimizer's LR on its schedule
            # (utils.py:127-133)
            set_lr(opt, lr)
        say(f"\nEpoch: [{epoch + 1} | {cfg.stop_epoch}] LR: {lr}")

        t = time.time()
        tl, t1, t5 = AverageMeter(), AverageMeter(), AverageMeter()
        nb = 0
        for images, labels in pipeline.batches(
                trainset, train_idx, cfg.batch_size, shuffle=True, seed=epoch):
            y = torch.as_tensor(labels.astype(np.int64), device=device)
            rows = shard = None
            if mesh is not None:
                rows = shard_rows(len(labels), mesh, rank)
                y, shard = y[rows], (rows, len(labels))
            x = ingest(images, train=True, generator=gen, rows=rows)
            loss, logits = train_step(model, opt, cfg, x, y, gen, shard)
            p1, p5 = topk_accuracy(logits.cpu().numpy(), labels)
            tl.update(float(loss), len(labels))
            t1.update(p1, len(labels))
            t5.update(p5, len(labels))
            nb += 1
            if cfg.verbose and nb % 50 == 0:
                say(f"[{nb}] Avg. Train Loss: {tl.avg:.3f} | "
                      f"Top-1 Acc: {t1.avg:.3f}% | Top-5 Acc: {t5.avg:.3f}%")
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        epoch_s.append(time.time() - t)
        steps += nb
        epochs += 1
        say(f"Time for training epoch {epoch}: {epoch_s[-1] / 60:.2f} min")

        if (epoch % cfg.save_freq == 0) or (epoch == cfg.stop_epoch - 1):
            save(f"{epoch}.tar", epoch, t1.avg, t5.avg)

        # validation, unsharded (rank 0's, sent to every rank)
        val = torch.zeros(3, dtype=torch.float64)
        if rank == 0:
            vl, v1, v5, _ = evaluate(model, ingest, trainset, val_idx,
                                     cfg.test_batch_size, device)
            val = torch.tensor([vl.avg, v1.avg, v5.avg], dtype=torch.float64)
        if mesh is not None:
            val = broadcast(val.to(coll_device()))
        val_loss, val1, val5 = val.tolist()
        say(f"Avg. Val Loss: {val_loss:.3f} | Top-1 Acc: {val1:.3f}% | "
              f"Top-5 Acc: {val5:.3f}%")
        if val1 > best_val:
            best_val = val1
            save("best.tar", epoch, val1, val5)

        if rank == 0:
            with open(log_path, "a") as lf:
                lf.write(json.dumps({
                    "epoch": epoch, "lr": lr, "train_loss": round(tl.avg, 5),
                    "train_top1": round(t1.avg, 3),
                    "val_loss": round(val_loss, 5), "val_top1": round(val1, 3),
                    "val_top5": round(val5, 3),
                }) + "\n")

        if stopper(val_loss):
            say(f"Early stopping at epoch: {epoch}")
            break
    if rank != 0:
        return None

    # final test with the best model
    best = os.path.join(ckpt_dir, "best.tar")
    if os.path.exists(best):
        ck = load_ckpt(best)
        model = QATResNet(*ck["state"], spec).to(device)
        say(f"Loaded best model {best} (epoch {ck['epoch']})")
    test_idx = np.arange(len(testset))
    _, _, _, preds = evaluate(model, ingest, testset, test_idx,
                              max(cfg.test_batch_size, 2), device)
    correct = int((preds == testset.labels[test_idx]).sum())
    total = len(test_idx)
    say(f"Test Acc: {correct}/{total} ({100.0*correct/max(total,1):.2f}%)")
    if cfg.dataset in ("cifar10", "Imagenette", "synthetic"):
        # confusion-matrix heatmap (reference train.py:418-419)
        from .viz import confusion_heatmap
        confusion_heatmap(ckpt_dir, testset.labels[test_idx], preds,
                          testset.classes)
    say("Done")
    return {"best_val": best_val, "test_top1": 100.0 * correct / max(total, 1),
            "test_correct": correct, "test_total": total, "epochs": epochs,
            "steps": steps, "epoch_s": epoch_s, "ckpt_dir": ckpt_dir}


if __name__ == "__main__":
    try:
        main()
    except KeyboardInterrupt:
        print("Interrupted")
        sys.exit(130)
