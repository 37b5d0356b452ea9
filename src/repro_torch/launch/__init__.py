"""Launchers of the port: training (``python -m repro_torch.launch.train``)."""
