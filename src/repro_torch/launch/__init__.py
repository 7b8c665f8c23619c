# Entry points: ``python -m repro_torch.launch.<name>`` (train,
# lora_finetune_backbone, train_relief_har, train_async_har, experiments,
# serve, profile_serve, dryrun, quickstart, baseline_duel, serve_backbone,
# fleet_scale_sim); serving_engine and step_fns are pieces of the serve and
# train paths.
