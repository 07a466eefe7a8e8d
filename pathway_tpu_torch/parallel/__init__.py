"""Engine worker parallelism: ``sharded.ShardCluster`` (threads of one process)."""
