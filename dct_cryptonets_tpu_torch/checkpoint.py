"""Checkpoints without JAX, counterpart of ``dct_cryptonets_tpu.train``'s
``save_ckpt`` and ``load_ckpt``.

A JAX training checkpoint is a pickle of ``{"epoch", "state": (params,
state), "prec1", "prec5", "optimizer"}`` whose arrays are numpy.  Its
``optimizer`` entry holds optax state tuples, so a plain ``pickle.load``
imports optax and with it JAX.  :func:`load_ckpt` unpickles with a
restricted ``Unpickler``: numpy's reconstruction globals are allowed,
optax's classes become inert tuple stubs, and any other global is refused.
The returned ``(params, state)`` pytree is what both the port's model
(``models.resnet.QATResNet``) and compiler (``fhe.compiler.lower``) read.

:func:`save_ckpt` writes the same payload.  Its ``optimizer`` entry is a
``torch.optim`` state dict with every tensor turned into a numpy array
(:func:`optimizer_state_to_numpy`), so a plain ``pickle.load`` (the JAX
package's ``load_ckpt``) and this module's restricted one both read it,
and a resume takes it back from :func:`load_ckpt`.
"""
import importlib
import pickle

import numpy as np
import torch

_NUMPY_PREFIXES = ("numpy.", "numpy")


class _OptaxStub(tuple):
    """Stand-in for an optax state NamedTuple: keeps the fields as a tuple."""

    def __new__(cls, *args, **kwargs):
        return super().__new__(cls, tuple(args) + tuple(kwargs.values()))

    def __reduce__(self):
        # pickles again as a plain tuple, with no import of optax
        return tuple, (tuple(self),)


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module == "optax" or module.startswith("optax."):
            return type(name, (_OptaxStub,), {"__module__": module})
        if module in _NUMPY_PREFIXES or module.startswith("numpy."):
            try:
                mod = importlib.import_module(module)
            except ImportError:
                # numpy < 2 names numpy._core as numpy.core
                mod = importlib.import_module(
                    module.replace("numpy._core", "numpy.core"))
            return getattr(mod, name)
        if module in ("builtins", "collections") and name in (
                "dict", "list", "tuple", "set", "frozenset", "OrderedDict"):
            return getattr(importlib.import_module(module), name)
        raise pickle.UnpicklingError(
            f"checkpoint references {module}.{name}, which is not allowed")


def load_ckpt(path: str) -> dict:
    """Load a training checkpoint of either package: returns its payload,
    a dict with ``epoch``, ``prec1``, ``prec5`` (when present), ``state`` =
    (params, state) numpy pytree and ``optimizer`` as it was saved (a JAX
    checkpoint's optax state as tuple stubs)."""
    with open(path, "rb") as fh:
        return _Unpickler(fh).load()


def optimizer_state_to_numpy(obj):
    """A ``torch.optim`` state dict with its tensors as numpy arrays."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy().copy()
    if isinstance(obj, dict):
        return {k: optimizer_state_to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(optimizer_state_to_numpy(v) for v in obj)
    return obj


def optimizer_state_from_numpy(obj):
    """Inverse of :func:`optimizer_state_to_numpy`."""
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(obj.copy())
    if isinstance(obj, dict):
        return {k: optimizer_state_from_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(optimizer_state_from_numpy(v) for v in obj)
    return obj


def save_ckpt(path, epoch, params, state, opt_state, prec1, prec5):
    """Write a checkpoint with the JAX trainer's payload keys; ``params``
    and ``state`` are numpy pytrees, ``opt_state`` a numpy state dict."""
    payload = {"epoch": epoch, "state": (params, state), "prec1": prec1,
               "prec5": prec5, "optimizer": opt_state}
    with open(path, "wb") as f:
        pickle.dump(payload, f)
