"""Collectives of the sharded engine over explicit per-shard tensors."""
