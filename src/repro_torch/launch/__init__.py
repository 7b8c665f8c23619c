# Entry points: ``python -m repro_torch.launch.<name>`` (train_async_har,
# serve); serving_engine and step_fns are the serve path's pieces.
