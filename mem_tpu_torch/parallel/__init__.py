"""Multi-process training on torch.distributed, port of mem_tpu/parallel/:
the process group, the mesh and the placements (mesh.py) and GPipe pipeline
parallelism (pipeline.py)."""
from mem_tpu_torch.parallel.mesh import (
    Placement,
    fsdp_specs,
    get_mesh,
    global_quotient,
    init_distributed,
    is_main,
    local_batch_size,
    place_train_state,
    psum_metrics,
    replicate,
    shard_batch,
    tp_param_specs,
    unreplicate,
    zero1_opt_specs,
)
from mem_tpu_torch.parallel.pipeline import (
    pipeline_apply,
    pipeline_param_sharding,
    stack_stage_params,
)
