"""The staged-parallelism tiers: row-sharded, replicated and tensor-parallel forwards over a mesh of shard slots."""
