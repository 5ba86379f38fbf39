"""Parallelism on torch.distributed: process groups and meshes, the
time-sharded channel filter, the candidate-parallel ML equalizer, the
two-stage TX pipeline and the multi-rank dry run."""
