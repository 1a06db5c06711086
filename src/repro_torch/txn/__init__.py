# TPC-C on one card: the port of repro.txn (the five-transaction mix in the
# merge and escrow regimes, both escrow layouts, the RAMP reads, the closed
# loop fused and by dispatch, the 2PC baseline, the audit, crash recovery).
from .tpcc import (TPCCScale, TPCCState, NewOrderBatch, OrderStatusBatch,
                   PaymentBatch, StockDelta, StockLevelBatch,
                   init_state, generate_neworder, generate_order_status,
                   generate_payment, generate_stock_level,
                   apply_neworder, apply_neworder_escrow,
                   apply_neworder_escrow_sparse, apply_payment,
                   apply_delivery, apply_stock_updates_strict_tiered,
                   check_consistency, default_hot_items, escrow_layout_bytes,
                   escrow_share_for, item_popularity, make_escrow_shares,
                   select_hot_cells, state_shape_dtypes, tpcc_invariants,
                   tpcc_state_specs)
from .ramp import (OrderStatusResult, StockLevelResult, apply_order_status,
                   apply_stock_level, conceal_lines, delivery_read,
                   publish_lines, read_lines)
from .engine import Engine, plan_engine, single_host_engine
from .executor import (FusedExecutor, MixChunk, MixCounters, OutboxRing,
                       get_fused_executor, stack_chunks)
from .drivers import (MixStats, RunStats, counters_to_stats,
                      generate_mix_batches, generate_neworder_stream,
                      run_closed_loop, run_escrow_loop, run_fused_escrow_loop,
                      run_fused_loop, run_loop, run_mixed_loop)
from .twopc import TwoPCEngine, run_closed_loop_2pc
from .audit import AuditReport, assert_audit, audit_tpcc
from .recovery import RestoredRun, restore_run, save_run
