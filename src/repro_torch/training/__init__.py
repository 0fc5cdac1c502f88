from repro_torch.training.train_loop import (init_state, make_train_step,
                                             opt_config_for)
