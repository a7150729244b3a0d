"""Launch layer: the serving entry point (`repro_torch.launch.serve`)."""
