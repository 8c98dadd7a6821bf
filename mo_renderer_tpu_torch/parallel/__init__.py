"""Multi-GPU rendering over ``torch.distributed`` (port of
``mo_renderer_tpu/parallel/``): the process group of the ranks, and one
frame's rows sharded over them.  One process per rank; NCCL between cards,
gloo between CPU processes."""

from .multi_view import RankGroup, make_rank_group  # noqa: F401
from .tile_sharding import TileShardedRenderer  # noqa: F401
