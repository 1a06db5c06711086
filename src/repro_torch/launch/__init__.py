# The port's launchers: serve.py (python -m repro_torch.launch.serve),
# tpcc_serve.py (the TPC-C serving driver) and train.py (python -m
# repro_torch.launch.train).
