"""Launch helpers of the port: the scoring mesh and the training launcher
(``python -m repro_torch.launch.train``)."""
