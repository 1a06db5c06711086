"""Frozen byte and operation counts of kernels B2 (``txn_megastep``) and
B3 (``ramp_read``), restated over the transaction batch and the state
they work on rather than over the kernels' arguments, so a change to a
kernel's interface leaves the yardstick where it is.

Each input byte the problem needs is counted once and each output byte
once, as a roofline's byte count should be; where the work depends on
the data, what these inputs need. The same idea as ``chip_smoke.py``'s
counts (B2's at its lines 395-412, B3's ``ramp_read_bytes``), without
their buffers: B2's dense ``[n_cells]`` product slabs are the port's
layout, not the problem's, and are left out.
"""

from __future__ import annotations

import numpy as np


def txn_megastep(batch: dict, n_items: int, w_lo: int, w_hi: int
                 ) -> tuple[int, int]:
    """(bytes, float32 operations) of one strict New-Order batch's
    admission and effects: the batch (home warehouse, district, line
    count and stamp a transaction; item, supply warehouse and quantity a
    line slot); the availability of each distinct cell its valid lines
    name, read and written; the price of each distinct (home warehouse,
    item) a valid line reads; each distinct district's counter, read and
    written; the three stock products of each distinct local cell; and
    the verdict and rank a transaction and the stamp and amount a line
    slot. The operations are the amounts' products, one a line slot."""
    w, n_lines = batch["w"], batch["n_lines"]
    i_id, supply = batch["i_id"], batch["supply_w"]
    B, L = i_id.shape
    lv = np.arange(L)[None, :] < n_lines[:, None]
    cells = supply.astype(np.int64)[lv] * n_items + i_id[lv]
    prices = np.broadcast_to(w[:, None], (B, L)).astype(np.int64)[lv] \
        * n_items + i_id[lv]
    local = (supply[lv] >= w_lo) & (supply[lv] < w_hi)
    keys = w.astype(np.int64) * 1024 + batch["d"]
    nbytes = (16 * B + 12 * B * L
              + 8 * np.unique(cells).size
              + 4 * np.unique(prices).size
              + 8 * np.unique(keys).size
              + 12 * np.unique(cells[local]).size
              + 5 * B + 8 * B * L)
    return int(nbytes), B * L


def ramp_read(rows: int, max_lines: int, needed: int, matched: int,
              matched_invisible: int, present: int) -> tuple[int, int]:
    """(bytes, float32 operations) of one Order-Status batch's fused read:
    each row's stamp and line count; each needed line's stamp, the
    visibility of a line whose stamp matches, the prepared bit of a
    matching line that is invisible, the amount and item of a line
    returned; every output once (the ``[rows, max_lines]`` selection, the
    amounts and items selected, and three row aggregates). The operations
    are the line-order sums, one a line slot."""
    nbytes = (8 * rows + 4 * needed + matched + matched_invisible + 8 * present
              + 9 * rows * max_lines + 12 * rows)
    return int(nbytes), rows * max_lines
