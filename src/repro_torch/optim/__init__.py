# The port of repro.optim: AdamW with escrow clipping (adamw.py), the
# compressed cross-pod merge (compression.py) and coordination-avoiding
# data parallelism, sync or deferred (coord.py).
from . import adamw, compression, coord
from .adamw import AdamWConfig, AdamWState
from .coord import CoordConfig, TrainSetup, TrainState, build
