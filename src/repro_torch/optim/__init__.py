from repro_torch.optim.adamw import OptConfig, lr_schedule, opt_init, opt_update
