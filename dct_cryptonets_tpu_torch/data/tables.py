"""Static DCT channel-subset index tables and normalization statistics
(counterpart of ``dct_cryptonets_tpu.data.tables``; it reads its own copy
of that package's JSON files, in ``data/tables`` beside this module).

Pure data extracted from the reference implementation (see
``tools/extract_reference_tables.py``):

* subset tables — reference ``data/cvtransforms.py:1600-1912``
  (``subset_channel_index``, ``..._square``, ``..._learned``, ``..._triangle``,
  ``..._filtersize_4``)
* normalization stats — reference ``data/__init__.py:289-360``
  (``train_upscaled_static_mean/std``, 192 entries: 64 Y + 64 Cb + 64 Cr)

Semantics mirrored from the reference:

* ``SubsetDCT`` (cvtransforms.py:117-142): for ``filter_size == 4`` the
  dedicated fs-4 table is used regardless of pattern; otherwise the table for
  the requested pattern.  ``channels == 192`` selects all 64 coefficients of
  each component.
* ``NormalizeDCT`` (cvtransforms.py:152-208): the per-channel mean/std vector
  is gathered from the 192-entry stats using the *default fs-8* table for the
  given channel budget — even when ``filter_size == 4`` selected different
  coefficient indices.  This reference quirk is load-bearing for checkpoint
  parity, so we reproduce it exactly.
"""
import json
import os
from functools import lru_cache

import numpy as np

_TABLE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tables")


@lru_cache(maxsize=None)
def _load(name):
    with open(os.path.join(_TABLE_DIR, name)) as f:
        return json.load(f)


def subset_indices(channels: int, pattern: str = "default", filter_size: int = 8):
    """Return (y_idx, cb_idx, cr_idx) coefficient index lists.

    Mirrors reference ``SubsetDCT.__init__`` (cvtransforms.py:117-137).
    """
    tables = _load("subset_channels.json")
    if channels == 192:
        full = list(range(64))
        return full, list(full), list(full)
    if filter_size == 4:
        table = tables["subset_channel_index_filtersize_4"]
    elif pattern == "default":
        table = tables["subset_channel_index"]
    elif pattern == "square":
        table = tables["subset_channel_index_square"]
    elif pattern == "learned":
        table = tables["subset_channel_index_learned"]
    elif pattern == "triangle":
        table = tables["subset_channel_index_triangle"]
    else:
        raise ValueError(f"unknown dct pattern {pattern!r}")
    key = str(channels)
    if key not in table:
        raise ValueError(
            f"channel budget {channels} not in table (have {sorted(table)})"
        )
    y, cb, cr = table[key]
    return list(y), list(cb), list(cr)


def normalization_stats(channels: int, pattern: str | None = None):
    """Per-channel (mean, std) arrays for the aggregated Y‖Cb‖Cr tensor.

    Mirrors reference ``NormalizeDCT.__init__`` (cvtransforms.py:162-185):
    stats are gathered from the 192-entry ``train_upscaled_static_*`` vectors
    at indices ``y_idx + [64+c for cb_idx] + [128+c for cr_idx]`` where the
    indices always come from the *default* fs-8 pattern table (the reference
    never forwards ``pattern`` or ``filter_size`` to NormalizeDCT).
    """
    stats = _load("dct_stats.json")
    mean192 = np.asarray(stats["train_upscaled_static_mean"], dtype=np.float32)
    std192 = np.asarray(stats["train_upscaled_static_std"], dtype=np.float32)
    if channels >= 192:
        return mean192, std192
    tables = _load("subset_channels.json")
    if pattern in (None, "default"):
        table = tables["subset_channel_index"]
    elif pattern == "square":
        table = tables["subset_channel_index_square"]
    elif pattern == "learned":
        table = tables["subset_channel_index_learned"]
    elif pattern == "triangle":
        table = tables["subset_channel_index_triangle"]
    else:
        raise ValueError(f"unknown dct pattern {pattern!r}")
    y, cb, cr = table[str(channels)]
    idx = list(y) + [64 + c for c in cb] + [128 + c for c in cr]
    return mean192[idx], std192[idx]
