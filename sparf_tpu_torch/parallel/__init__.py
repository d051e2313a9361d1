"""Ray-sharded data parallelism over processes (torch port of sparf_tpu/parallel)."""
from sparf_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    on_rank0,
    replicate_tree,
    shard_rays,
)
