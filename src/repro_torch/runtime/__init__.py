# The port of repro.runtime: serve.py, the serving runtime (a static-batch
# server with coordination-free bookkeeping); liveness.py, the lease
# monitor that derives the alive mask from heartbeats; failures.py, the
# escrow pod simulator (kill, stall, revive, checkpoint and recover) and the
# analytic straggler model. train.py and failures.py's PodSimulator belong
# to the training analogue, ROADMAP Queue A item 10.
from .failures import EscrowPodSimulator, straggler_step_times
from .liveness import LeaseMonitor
