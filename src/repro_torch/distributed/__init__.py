from repro_torch.distributed.sharding import ShardCtx

__all__ = ["ShardCtx"]
