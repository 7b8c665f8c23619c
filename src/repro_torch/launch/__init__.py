# Entry points: ``python -m repro_torch.launch.<name>`` (train,
# lora_finetune_backbone, train_relief_har, train_async_har, experiments,
# serve, profile_serve); serving_engine and step_fns are pieces of the
# serve and train paths.
