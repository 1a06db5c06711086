# The port of repro.runtime: serve.py, the serving runtime (a static-batch
# server with coordination-free bookkeeping, every model family);
# liveness.py, the lease monitor that derives the alive mask from
# heartbeats; failures.py, the escrow pod simulator (kill, stall, revive,
# checkpoint and recover) and the analytic straggler model. Only training
# remains of ROADMAP Queue A item 10 here: train.py, the loss functions it
# calls, and failures.py's PodSimulator.
from .failures import EscrowPodSimulator, straggler_step_times
from .liveness import LeaseMonitor
