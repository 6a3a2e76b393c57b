"""Entry points of the port: ``python -m repro_torch.launch.serve``,
``python -m repro_torch.launch.serve_so3``,
``python -m repro_torch.launch.train`` and
``python -m repro_torch.launch.dryrun`` (with ``mesh``, ``specs`` and
``flops``, the production-mesh tooling)."""
