# The port's kernels, each a hand-written CUDA C++ kernel for Hopper
# (csrc/, built at first use by build.py) beside its plain torch version,
# with torch oracles in ref.py and public entries in ops.py:
#   escrow_admit.py  — contention gate + residual FCFS escrow admission
#   txn_megastep.py  — admission + committed effects + RAMP stamps
#   ramp_read.py     — the fused RAMP read of Order-Status
#   lattice_merge.py — the VersionedSlots join with its threshold audit
#   flash_attention.py — causal/full GQA attention (dense prefill)
#   rwkv6_scan.py    — the RWKV-6 WKV scan (RWKV prefill)
from . import ops, ref
from .escrow_admit import escrow_admit_cuda
from .flash_attention import flash_attention_cuda
from .lattice_merge import lattice_merge_cuda
from .ramp_read import ramp_read_cuda
from .rwkv6_scan import rwkv6_scan_cuda
from .txn_megastep import MegastepOut, txn_megastep_cuda
