"""Distribution: sharded encode and decode over a mesh of shards
(``shard``), over ``torch.distributed`` processes (``multihost``), and the
multi-shard dry run (``dryrun``)."""
