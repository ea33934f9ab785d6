"""Evaluation meters, the port's copy of ``AverageMeter`` and
``topk_accuracy`` from ``dct_cryptonets_tpu.utils`` (behavioral parity with
the reference's utils.py:74-124), host-side numpy."""
import numpy as np


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
