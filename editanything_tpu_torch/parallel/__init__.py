"""Parallelism over ``torch.distributed``: batch shards, gathers,
broadcasts and the DDP wrap of the trainers, and the (data, model) mesh
with its tensor-parallel and FSDP layouts."""
