from repro_torch.kernels.persistent.kernel import (NUM_DRAIN_OPS, NUM_OPS,
                                                   OP_ADD, OP_COPY, OP_MATMUL,
                                                   OP_NOP, OP_REDUCE, OP_RELU,
                                                   OP_SCALE, SCALE_SHIFT, TILE,
                                                   drain_plain, execute_plain,
                                                   pack_args, pack_scale)
from repro_torch.kernels.persistent.ops import (TILE_OP_NAMES,
                                                TILE_RESULT_TEMPLATE,
                                                build_queue, mlp_program,
                                                persistent_drain,
                                                persistent_drain_prof,
                                                persistent_execute,
                                                tile_state, tile_work_table)
