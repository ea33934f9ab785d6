"""Training utilities, the port's copy of ``dct_cryptonets_tpu.utils``:
meters, early stopping, top-k accuracy and the step-decay LR (behavioral
parity with the reference's utils.py:74-138), host-side numpy; and the
CLIs' ``--profile_dir`` wrapper (:func:`run_profiled`)."""
import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler


class AverageMeter:
    """Weighted running average over a stream of (value, weight) updates.

    Same contract as the reference's loss/top-k meters (utils.py:74-89):
    ``update(v, n)`` folds in a batch mean over ``n`` samples, ``avg`` is
    the sample-weighted mean so far.
    """

    __slots__ = ("_total", "_weight", "last")

    def __init__(self):
        self.reset()

    def reset(self):
        self._total = 0.0
        self._weight = 0
        self.last = None

    def update(self, value, n=1):
        self.last = float(value)
        self._total += float(value) * n
        self._weight += n

    @property
    def avg(self):
        return self._total / self._weight if self._weight else 0.0


class EarlyStopper:
    """Stop when validation loss hasn't recovered for ``patience`` epochs.

    Reference semantics (utils.py:92-108): an epoch counts against the
    streak only when it exceeds the best loss by more than ``threshold``;
    any new best resets the streak.
    """

    def __init__(self, patience=10, threshold=0.03):
        self.patience = patience
        self.threshold = threshold
        self._best = float("inf")
        self._streak = 0

    def __call__(self, val_loss) -> bool:
        if val_loss < self._best:
            self._best = val_loss
            self._streak = 0
            return False
        if val_loss > self._best + self.threshold:
            self._streak += 1
        return self._streak >= self.patience


def topk_accuracy(logits, targets, ks=(1, 5)):
    """Top-k accuracy in percent (reference utils.py:111-124)."""
    logits = np.asarray(logits)
    targets = np.asarray(targets)
    maxk = min(max(ks), logits.shape[1])
    pred = np.argsort(-logits, axis=1)[:, :maxk]
    correct = pred == targets[:, None]
    out = []
    for k in ks:
        kk = min(k, logits.shape[1])
        out.append(100.0 * correct[:, :kk].any(axis=1).mean())
    return out


def step_decay_lr(base_lr, schedule, gamma, epoch):
    """LR after step decays at `schedule` epochs (reference utils.py:127-133,
    applied with epoch+1 semantics)."""
    lr = base_lr
    if schedule:
        for e in schedule:
            if epoch + 1 >= e:
                lr *= gamma
    return lr


def run_profiled(cfg, main_impl):
    """``main_impl(cfg)``, under ``torch.profiler`` when ``cfg.profile_dir``
    is set, as the JAX CLIs run it under ``jax.profiler.trace``: the host's
    operators, and the card's kernels when the run is on CUDA, written as
    one Chrome/TensorBoard trace (``*.pt.trace.json``) into that
    directory."""
    if not getattr(cfg, "profile_dir", None):
        return main_impl(cfg)
    activities = [ProfilerActivity.CPU]
    if cfg.device == "cuda":
        activities.append(ProfilerActivity.CUDA)
    out_dir, cfg.profile_dir = cfg.profile_dir, None
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(out_dir)):
        result = main_impl(cfg)
        if cfg.device == "cuda":
            torch.cuda.synchronize()
    return result
