# The port of repro.data: the deterministic synthetic training pipeline
# with replica-namespaced sample IDs and max-join shard cursors.
from .pipeline import DataConfig, Pipeline, ShardCursor
