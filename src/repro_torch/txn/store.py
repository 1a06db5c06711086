"""Columnar, versioned, masked store — the port of ``repro.txn.store``.

A :class:`Table` is a fixed-capacity columnar structure:

* ``columns`` — dict of name -> [capacity, ...] tensors
* ``valid``   — [capacity] bool (live rows)
* ``version`` — [capacity] int64, replica-namespaced stamps

Insert-only tables merge by or-join on ``valid``; updatable tables merge by
higher-version-wins per row (LWW at row granularity with unique stamps).

Stamps are int64 always: the reference's ``version_dtype()`` is int64 only
under ``jax_enable_x64`` (its production setting) and int32 otherwise.
:meth:`Table.join` is plain torch, a ``where`` per column, like the
reference's: a dict of columns is not kernel B4's [R, W] layout.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import torch

from repro_torch.device import resolve_device


def version_dtype() -> torch.dtype:
    return torch.int64


def _rows(sel: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """The row mask ``sel`` shaped to broadcast over ``col``'s rows."""
    return sel.reshape(sel.shape + (1,) * (col.ndim - sel.ndim))


@dataclasses.dataclass
class Table:
    columns: dict[str, torch.Tensor]
    valid: torch.Tensor
    version: torch.Tensor

    # -- tree protocol (core/tree.py): flattens as the reference's pytree --
    def tree_flatten(self):
        names = tuple(sorted(self.columns))
        children = tuple(self.columns[n] for n in names) + (self.valid,
                                                           self.version)
        return children, names

    @classmethod
    def tree_unflatten(cls, names, children):
        return cls(dict(zip(names, children[:-2])), children[-2],
                   children[-1])

    # -- construction ------------------------------------------------------
    @staticmethod
    def make(capacity: int, schema: Mapping[str, Any],
             device=None) -> "Table":
        """schema: name -> dtype or (shape_suffix, dtype). The table lives
        on ``device`` (the CUDA card unless the caller asks for the CPU)."""
        dev = resolve_device(device)
        cols = {}
        for name, spec in schema.items():
            suffix, dtype = spec if isinstance(spec, tuple) else ((), spec)
            cols[name] = torch.zeros((capacity, *suffix), dtype=dtype,
                                     device=dev)
        return Table(cols, torch.zeros((capacity,), dtype=torch.bool,
                                       device=dev),
                     torch.full((capacity,), -1, dtype=version_dtype(),
                                device=dev))

    @property
    def capacity(self) -> int:
        return self.valid.shape[0]

    def count(self) -> torch.Tensor:
        return self.valid.sum()

    # -- row operations (vectorized; idx may be an array) ------------------
    def _write(self, idx, rows: Mapping[str, Any], version, gate
               ) -> "Table":
        """Write ``rows`` at ``idx`` where ``gate(idx, version)`` holds; the
        rows become valid and their stamps rise to ``version``."""
        dev = self.valid.device
        idx = torch.as_tensor(idx, device=dev).long()
        version = torch.as_tensor(version, dtype=self.version.dtype,
                                  device=dev)
        sel = gate(idx, version)
        cols = dict(self.columns)
        for name, vals in rows.items():
            col = cols[name]
            old = col[idx]
            vals = torch.as_tensor(vals, dtype=col.dtype, device=dev)
            cols[name] = col.clone()
            cols[name][idx] = torch.where(_rows(sel, old), vals, old)
        valid = self.valid.clone()
        valid[idx] = True
        stamps = self.version.clone().scatter_reduce_(
            0, idx.reshape(-1), version.expand(idx.shape).reshape(-1),
            "amax")
        return Table(cols, valid, stamps)

    def insert(self, idx, rows: Mapping[str, Any], version) -> "Table":
        """Insert rows at ``idx`` (first-writer-wins on already-valid
        rows)."""
        return self._write(idx, rows, version,
                           lambda i, v: ~self.valid[i])

    def update(self, idx, rows: Mapping[str, Any], version) -> "Table":
        """Overwrite columns at ``idx`` if the new version is higher."""
        return self._write(idx, rows, version,
                           lambda i, v: v > self.version[i])

    def delete(self, idx) -> "Table":
        valid = self.valid.clone()
        valid[torch.as_tensor(idx, device=valid.device).long()] = False
        return dataclasses.replace(self, valid=valid)

    # -- merge (⊔) ---------------------------------------------------------
    @staticmethod
    def join(a: "Table", b: "Table") -> "Table":
        """Row-wise higher-version-wins; valid = or-join. With
        replica-namespaced versions, commutative, associative and
        idempotent."""
        b_newer = b.version > a.version
        cols = {name: torch.where(_rows(b_newer, col), b.columns[name], col)
                for name, col in a.columns.items()}
        return Table(cols, a.valid | b.valid,
                     torch.maximum(a.version, b.version))


def namespaced_version(counter, replica, num_replicas: int) -> torch.Tensor:
    """Unique, replica-namespaced version stamps (§5.1 'choose some
    value'), int64. The result lies where ``counter`` lies (a Python number
    gives a 0-d CPU tensor, which broadcasts against tensors on any
    device)."""
    return torch.as_tensor(counter, dtype=version_dtype()) * num_replicas \
        + replica
