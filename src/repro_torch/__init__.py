"""repro_torch — the PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package imports nothing
from it. The New-Order slice: the analysis core (core/), TPC-C New-Order in
the merge and sparse-escrow regimes with its closed loop and audit (txn/),
and hand-written CUDA kernels for escrow admission and the transaction
megastep, each beside its plain torch version (kernels/). Entry points run
on the CUDA card unless the caller passes ``device="cpu"``.
"""

from . import core, kernels, txn
from .convert import (batch_from_numpy, escrow_from_numpy, state_from_numpy,
                      state_to_numpy)
from .device import resolve_device
