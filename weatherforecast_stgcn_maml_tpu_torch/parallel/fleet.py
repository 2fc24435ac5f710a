"""Region-fleet partitioning for runs over several hosts.

Regional adaptation jobs are independent: each host takes a partition of
the region list, and the hosts share checkpoints through the filesystem.
The port runs one process, so `auto_shard()` gives the whole list to it;
several hosts pass `--shard` / `--num-shards` explicitly.
"""

from __future__ import annotations


def partition_round_robin(items, num_shards: int, shard_id: int):
    """Deterministic round-robin partition (balanced to within one item)."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    if not 0 <= shard_id < num_shards:
        raise ValueError(f"shard_id {shard_id} out of range [0, {num_shards})")
    return [x for i, x in enumerate(items) if i % num_shards == shard_id]


def auto_shard() -> tuple[int, int]:
    """(shard_id, num_shards) of this process: (0, 1), one process."""
    return 0, 1
