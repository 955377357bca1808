"""Launchers of the workload plane (`python -m repro_torch.launch.serve`)."""
