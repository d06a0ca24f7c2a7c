"""The rank mesh and the parallel programs (data and template axes)."""

from nope_tpu_torch.parallel.mesh import (  # noqa: F401
    create_mesh,
    data_sharding,
    template_sharding,
    replicate,
    shard_batch,
)
from nope_tpu_torch.parallel.eval import (  # noqa: F401
    make_sharded_eval_fn,
    make_sharded_streaming_eval_fn,
)
from nope_tpu_torch.parallel.zero import (  # noqa: F401
    zero1_state_shardings,
    sharded_param_bytes,
)
