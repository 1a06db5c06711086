# The port of repro.runtime: serve.py, the serving runtime (a static-batch
# server with coordination-free bookkeeping, every model family);
# train.py, the training loop (sync or deferred pods, checkpoint and
# restart); liveness.py, the lease monitor that derives the alive mask from
# heartbeats; failures.py, the training pod simulator (kill, recover,
# merge), the escrow pod simulator (kill, stall, revive, checkpoint and
# recover) and the analytic straggler model.
from .failures import EscrowPodSimulator, PodSimulator, straggler_step_times
from .liveness import LeaseMonitor
