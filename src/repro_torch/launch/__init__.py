"""Entry points of the port: ``python -m repro_torch.launch.serve``,
``python -m repro_torch.launch.serve_so3`` and
``python -m repro_torch.launch.train``."""
