from .sharding import cross_shard, make_sharded_fit_fn, padded_global_batch, shard_batch

__all__ = ['cross_shard', 'make_sharded_fit_fn', 'padded_global_batch', 'shard_batch']
