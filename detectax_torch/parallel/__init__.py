from detectax_torch.parallel.mesh import (  # noqa: F401
    DataParallel,
    all_reduce_sum,
    make_sharded_eval_fn,
    maybe_initialize_distributed,
    replicate_state,
    shard_batch,
)
