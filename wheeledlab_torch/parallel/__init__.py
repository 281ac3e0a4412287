"""Multi-process data-parallel training over `torch.distributed`: the port of
`wheeledlab_tpu/parallel/` (`distributed`: the process group and its
collectives; `mesh`: the shard arithmetic)."""
