"""Data parallelism of the port over `torch.distributed` (`mesh.py`) and
the multi-process portability drive (`multiprocess.py`)."""

from fashionern_aaai2024_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    ProcessMesh,
    create_mesh,
    initialize_distributed,
    local_batch_size,
    shard_batch,
    spawn_cpu_gang,
)
