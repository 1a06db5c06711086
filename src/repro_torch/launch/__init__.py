# The port's launchers: serve.py (python -m repro_torch.launch.serve).
