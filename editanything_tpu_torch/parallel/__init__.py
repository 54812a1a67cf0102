"""Data parallelism over ``torch.distributed``: batch shards, gathers,
broadcasts and the DDP wrap of the trainers."""
