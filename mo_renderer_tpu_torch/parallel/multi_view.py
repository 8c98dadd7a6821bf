"""The ranks a sharded frame runs on (port of the mesh half of
``mo_renderer_tpu/parallel/multi_view.py``).

``make_view_mesh`` (multi_view.py:35) lays a 1-D mesh over the devices of
one JAX program.  Here each rank is its own process, so its counterpart is
a ``torch.distributed`` process group over the ranks, with this process's
rank and the group's size.  The caller initialises ``torch.distributed``
(``init_process_group`` with its own address, world size and rank) and
hands the group to the renderer: nothing here reads the default group
behind the caller's back.  ``MultiViewRenderer`` waits for camera-path
sequences (ROADMAP Queue 1 item 13).
"""

from __future__ import annotations

import dataclasses

import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class RankGroup:
    """A process group and this process's place in it."""

    group: dist.ProcessGroup
    rank: int  # this process's rank in ``group``
    size: int  # the number of ranks in ``group``


def make_rank_group(ranks=None, backend=None) -> RankGroup:
    """A process group over ``ranks`` (every rank of the initialised
    ``torch.distributed`` world by default), on ``backend`` (the world's
    by default; "gloo" gives a card's process a group for CPU tensors).
    Every rank of the world calls it, as ``dist.new_group`` requires."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_rank_group: initialise torch.distributed first "
            "(init_process_group with an address, world size and rank)"
        )
    group = dist.new_group(ranks, backend=backend)
    return RankGroup(group=group, rank=dist.get_rank(group),
                     size=dist.get_world_size(group))
