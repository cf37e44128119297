"""Data-sharded training: shard placement, speculation, the sharded loop."""
