"""Data parallelism on ``torch.distributed``: the process group, batch
shards and the collectives of the train steps."""
