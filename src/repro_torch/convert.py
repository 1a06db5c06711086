"""Carry state between the reference (as numpy) and the port.

The reference runs with x64 off, so every array converts with its dtype
pinned: bool stays bool, integers become int32, floats float32. The test
side hands over numpy arrays (``jax.device_get``); this module never sees
a JAX array type.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.lattice import HotSetEscrow
from repro_torch.txn.tpcc import (NewOrderBatch, OrderStatusBatch,
                                  PaymentBatch, StockLevelBatch, TPCCState)


def _pinned(a) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype == np.bool_:
        return a
    if np.issubdtype(a.dtype, np.integer):
        return a.astype(np.int32)
    if np.issubdtype(a.dtype, np.floating):
        return a.astype(np.float32)
    raise TypeError(f"no pinned dtype for {a.dtype}")


def _from_numpy(cls, src, device):
    fields = src._asdict() if hasattr(src, "_asdict") else dict(src)
    return cls(**{f: torch.tensor(_pinned(fields[f]), device=device)
                  for f in cls._fields})


def state_from_numpy(src, device) -> TPCCState:
    """A reference ``TPCCState`` (NamedTuple or dict of numpy arrays) as the
    port's ``TPCCState`` on ``device``."""
    return _from_numpy(TPCCState, src, device)


def escrow_from_numpy(src, device) -> HotSetEscrow:
    """A reference ``HotSetEscrow`` as the port's, on ``device``."""
    return _from_numpy(HotSetEscrow, src, device)


def batch_from_numpy(src, device) -> NewOrderBatch:
    """A reference ``NewOrderBatch`` as the port's, on ``device``."""
    return _from_numpy(NewOrderBatch, src, device)


def payment_batch_from_numpy(src, device) -> PaymentBatch:
    """A reference ``PaymentBatch`` as the port's, on ``device``."""
    return _from_numpy(PaymentBatch, src, device)


def order_status_batch_from_numpy(src, device) -> OrderStatusBatch:
    """A reference ``OrderStatusBatch`` as the port's, on ``device``."""
    return _from_numpy(OrderStatusBatch, src, device)


def stock_level_batch_from_numpy(src, device) -> StockLevelBatch:
    """A reference ``StockLevelBatch`` as the port's, on ``device``."""
    return _from_numpy(StockLevelBatch, src, device)


def state_to_numpy(nt: NamedTuple) -> NamedTuple:
    """Any NamedTuple of tensors (state, escrow, batch, outbox) as the same
    NamedTuple of host numpy arrays; numpy fields pass through."""
    return type(nt)(*(x.detach().cpu().numpy() if torch.is_tensor(x)
                      else np.asarray(x) for x in nt))
