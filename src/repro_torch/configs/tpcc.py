"""The paper's own workload: TPC-C at spec cardinalities, warehouse-sharded
(the port of ``repro.configs.tpcc``). Selectable as ``--arch tpcc`` in the
dry run (``repro_torch.launch.dryrun``), which traces the TPC-C paths in
place of a train or serve step."""
from repro_torch.txn.tpcc import TPCCScale


def config(n_warehouses: int = 512) -> TPCCScale:
    return TPCCScale.spec_scale(n_warehouses=n_warehouses)
