"""repro_torch — the PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package imports nothing
from it. It holds the analysis core with the lattices, the Theorem 1
witnesses and the anti-entropy merges of state trees (core/); TPC-C's
five-transaction mix in the merge and sparse-escrow regimes with its
closed loop, RAMP reads, audit and the versioned store (txn/); and six
hand-written CUDA kernels, each beside its plain torch version (kernels/):
escrow admission, the transaction megastep, the fused RAMP read, the
versioned-table merge with its audit, attention for the dense prefill and
the RWKV-6 scan for the RWKV prefill. It serves language models
(models/, configs/, runtime/serve.py, launch/serve.py): all six families,
with random weights, through a static-batch server whose bookkeeping is
coordination-free; and trains them (optim/, data/, runtime/train.py,
launch/train.py): AdamW with escrow clipping, synchronous or deferred
data parallelism over pods with a compressed merge, checkpoints and
restarts, and a pod failure simulator. Entry points run on the CUDA card
unless the caller passes ``device="cpu"``.
"""

from . import core, kernels, txn
from .convert import (batch_from_numpy, escrow_from_numpy, params_from_numpy,
                      params_to_numpy, state_from_numpy, state_to_numpy,
                      train_state_from_numpy, train_state_to_numpy,
                      tree_from_numpy)
from .device import resolve_device
