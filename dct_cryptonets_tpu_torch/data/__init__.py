"""Data ingest (PyTorch port)."""
from .tables import subset_indices, normalization_stats  # noqa: F401
from .codec import (CodecConfig, dct_ingest, dct_ingest_sharded,  # noqa: F401
                    dct_ingest_train)
