"""Carry state and model parameters between the reference (as numpy) and
the port.

The reference runs with x64 off, so TPC-C state converts with its dtype
pinned: bool stays bool, integers become int32, floats float32. Lattice
state trees keep each array's dtype (bfloat16 included), except the
version stamps, which widen to the port's int64. The test side hands over
numpy arrays (``jax.device_get``); this module never sees a JAX array
type.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from torch import nn

from repro_torch.core import lattice
from repro_torch.core import tree as T
from repro_torch.core.lattice import HotSetEscrow
from repro_torch.txn.store import Table
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


# the stamp fields that widen to int64: (lattice type, field)
_STAMPS = {("VersionedSlots", "version"), ("LWWRegister", "ts")}
_LATTICES = {cls.__name__: cls for cls in lattice.LATTICE_TYPES}


def _tensor(a, device, dtype=None) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes: torch reads no such numpy
        t = torch.tensor(a.astype(np.float32), device=device).to(
            torch.bfloat16)
    else:
        t = torch.tensor(a, device=device)
    return t if dtype is None else t.to(dtype)


def tree_from_numpy(src, device):
    """A reference state tree of numpy arrays (``jax.device_get`` of dicts,
    lists, tuples, lattice NamedTuples and ``Table``s) as the port's, on
    ``device``. A lattice NamedTuple becomes the port's type of the same
    name and a ``Table`` the port's ``Table``; stamps widen to int64;
    ``LeaseLattice`` stamps stay host numpy int64, as in both packages."""
    name = type(src).__name__
    if name == "Table" and hasattr(src, "columns"):
        return Table({k: _tensor(v, device) for k, v in src.columns.items()},
                     _tensor(src.valid, device),
                     _tensor(src.version, device, torch.int64))
    if name == "LeaseLattice":
        return lattice.LeaseLattice(np.asarray(src.stamps, np.int64))
    if name in _LATTICES:
        return _LATTICES[name](*(
            _tensor(v, device, torch.int64) if (name, f) in _STAMPS
            else tree_from_numpy(v, device)
            for f, v in zip(src._fields, src)))
    if hasattr(src, "_fields"):
        raise TypeError(f"no port type for {name}")
    if isinstance(src, dict):
        return {k: tree_from_numpy(v, device) for k, v in src.items()}
    if isinstance(src, (list, tuple)):
        return type(src)(tree_from_numpy(v, device) for v in src)
    return _tensor(src, device)


def params_from_numpy(tree, cfg, device):
    """A reference model's parameter pytree as numpy arrays (dicts of
    float32 masters, each layer stack's leaves stacked on leading dims), as
    the port's model on ``device`` with the same values: one ``Params``
    group per dict, and each stack an ``nn.ModuleList`` whose entry i takes
    slice i of every leaf below it (``layers.bind``'s unstacking, each
    slice copied into a tensor of its own). The stacks (``layers.STACKS``):
    ``layers`` [L] (dense, moe, ssm, hybrid; a moe layer's expert tensors
    [E, d, f] stay whole in its group), whisper's ``enc_layers`` and
    ``dec_layers``, and the vlm's ``groups.self`` [G, S] (a list of G
    lists) and ``groups.cross`` [G]. A stack whose length differs from
    ``cfg``'s layer count raises. :func:`params_to_numpy` is the
    inverse."""
    from repro_torch.models.layers import Params, _length, bind

    def tensors(node):
        if isinstance(node, dict):
            return {k: tensors(v) for k, v in node.items()}
        return _tensor(np.asarray(node), device, torch.float32)

    def module(node):
        if isinstance(node, dict):
            return Params(**{k: module(v) for k, v in node.items()})
        if isinstance(node, list):
            return nn.ModuleList(module(v) for v in node)
        return node.clone()

    tree = tensors(tree)
    for name, want in (("layers", cfg.n_layers), ("dec_layers", cfg.n_layers),
                       ("enc_layers", cfg.enc_layers)):
        if name in tree and _length(tree[name]) != want:
            raise ValueError(f"{name} stacks {_length(tree[name])} layers, "
                             f"the configuration {want}")
    return module(bind(tree))


def _numpy(tree):
    return T.map(lambda x: x.detach().cpu().numpy(), tree)


def params_to_numpy(params: nn.Module) -> dict:
    """The port's model as the reference's parameter pytree of numpy
    arrays: each layer stack restacked on its leading dims
    (``layers.stacked``); the inverse of :func:`params_from_numpy`."""
    from repro_torch.models.layers import stacked
    return _numpy(stacked(params))


def train_state_from_numpy(src, device):
    """A reference ``TrainState`` as numpy (``jax.device_get`` of it: the
    parameter tree, the AdamW moments, pod dim included in a deferred
    mode, the count, step and metric slots) as the port's
    ``optim.coord.TrainState`` on ``device``, every leaf in its dtype."""
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.optim.coord import TrainState

    def tensors(tree):
        return T.map(lambda x: _tensor(x, device), tree)

    opt = src.opt
    return TrainState(tensors(src.params),
                      AdamWState(tensors(opt.mu), tensors(opt.nu),
                                 _tensor(opt.count, device)),
                      *(_tensor(x, device) for x in src[2:]))


def train_state_to_numpy(state):
    """The port's ``TrainState`` as the same NamedTuples of numpy arrays,
    in the reference's tree layout (the inverse of
    :func:`train_state_from_numpy`)."""
    return type(state)(_numpy(state.params),
                       type(state.opt)(*(_numpy(x) for x in state.opt)),
                       *(x.detach().cpu().numpy() for x in state[2:]))
