from detectax_torch.parallel.mesh import (  # noqa: F401
    DataParallel,
    Fsdp,
    all_gather_leaves,
    all_reduce_sum,
    fsdp_param_spec,
    make_sharded_eval_fn,
    maybe_initialize_distributed,
    reduce_scatter_leaves,
    replicate_state,
    shard_batch,
    shard_train_state,
)
