from tpu_llm_torch.parallel.mesh import make_mesh  # noqa: F401
from tpu_llm_torch.parallel.sharding import (  # noqa: F401
    llama_cache_spec,
    llama_paged_state_spec,
    llama_param_specs,
    shard_params,
)
