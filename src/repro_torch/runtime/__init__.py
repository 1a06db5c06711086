# The port of repro.runtime: serve.py, the serving runtime (a static-batch
# server with coordination-free bookkeeping). train.py, failures.py and
# liveness.py are ROADMAP Queue A items 9 and 10.
