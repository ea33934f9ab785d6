"""Device meshes, sharding and the multi-process layer (PyTorch port of
``dct_cryptonets_tpu.parallel``)."""
from .mesh import (  # noqa: F401
    data_mesh,
    shard_batch,
    replicate,
)
from .distributed import (  # noqa: F401
    global_data_mesh,
    host_chip_mesh,
    initialize,
    local_batch_to_global,
)
