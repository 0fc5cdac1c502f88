from repro_torch.distributed.sharding import (Axes, ShardCtx,
                                              attach_shardings, axes,
                                              logical_to_spec, make_rules)

__all__ = ["Axes", "ShardCtx", "attach_shardings", "axes", "logical_to_spec",
           "make_rules"]
