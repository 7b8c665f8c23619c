from repro_torch.optim.optimizers import adam_init, adam_update
