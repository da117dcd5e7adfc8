"""Entry points: the serve mesh (``mesh``) and the serving launcher
(``python -m repro_torch.launch.serve``)."""
