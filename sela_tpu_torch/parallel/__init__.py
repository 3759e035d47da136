"""Frame-axis sharding over devices and multi-process shard encode/merge
(frames are the data-parallel axis)."""
