from repro_torch.training.train_loop import (abstract_state, init_state,
                                             make_train_step, opt_config_for,
                                             place_state, state_axes,
                                             state_shardings)
