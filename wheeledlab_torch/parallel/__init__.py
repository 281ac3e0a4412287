"""Multi-process training over `torch.distributed`: the port of
`wheeledlab_tpu/parallel/` (`distributed`: the process group, the (data,
model) groups and the collectives; `mesh`: the grid, the shard arithmetic
and the tensor-parallel placement; `tensor_parallel`: the policy split over
a model group)."""

from .mesh import DATA_AXIS, MODEL_AXIS, make_mesh  # noqa: F401
from . import distributed  # noqa: F401
