"""Multi-GPU rendering over ``torch.distributed`` (port of
``mo_renderer_tpu/parallel/``): the process group of the ranks, a batch
of cameras over them, and one frame's rows sharded over them.  One
process per rank; NCCL between cards, gloo between CPU processes."""

from ..passes.frame_graph import stack_params  # noqa: F401
from .multi_view import (  # noqa: F401
    MultiViewRenderer,
    RankGroup,
    make_rank_group,
)
from .tile_sharding import TileShardedRenderer  # noqa: F401
