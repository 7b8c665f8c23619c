from repro_torch.optim.optimizers import (Optimizer, adam_init, adam_update,
                                          cosine_schedule,
                                          linear_warmup_cosine,
                                          make_optimizer, sgd_init,
                                          sgd_update)
