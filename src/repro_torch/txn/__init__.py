# TPC-C New-Order on one card: the port of repro.txn for the New-Order slice
# (merge and sparse escrow regimes, the dispatch closed loop, the audit).
from .tpcc import (TPCCScale, TPCCState, NewOrderBatch, StockDelta,
                   init_state, generate_neworder, apply_neworder,
                   apply_neworder_escrow_sparse,
                   apply_stock_updates_strict_tiered, check_consistency,
                   default_hot_items, escrow_layout_bytes, escrow_share_for,
                   item_popularity, select_hot_cells, tpcc_invariants,
                   tpcc_state_specs)
from .engine import Engine, single_host_engine
from .drivers import MixStats, RunStats, generate_neworder_stream, run_loop
from .audit import AuditReport, assert_audit, audit_tpcc
