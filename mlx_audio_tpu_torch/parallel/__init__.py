from mlx_audio_tpu_torch.parallel.mesh import (
    get_mesh,
    pmap_batches,
    replicate,
    shard_batch,
    shard_module,
    tp_rules_dia,
    tp_rules_llama,
)
from mlx_audio_tpu_torch.parallel.context import (
    MeshContext,
    activate_mesh,
    active_mesh,
    deactivate_mesh,
    pad_batch_arrays,
    parse_mesh_spec,
)

__all__ = [
    "get_mesh", "shard_batch", "shard_module", "replicate", "pmap_batches",
    "tp_rules_llama", "tp_rules_dia",
    "MeshContext", "activate_mesh", "active_mesh", "deactivate_mesh",
    "pad_batch_arrays", "parse_mesh_spec",
]
