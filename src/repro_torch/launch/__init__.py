"""Entry points of the port (``python -m repro_torch.launch.serve_pde``,
``python -m repro_torch.launch.train``)."""
