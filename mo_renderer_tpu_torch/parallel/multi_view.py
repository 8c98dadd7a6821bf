"""Multi-view rendering over ``torch.distributed`` ranks, data-parallel
over cameras (port of ``mo_renderer_tpu/parallel/multi_view.py``).

``make_view_mesh`` (multi_view.py:35) lays a 1-D mesh over the devices of
one JAX program.  Here each rank is its own process, so its counterpart is
a ``torch.distributed`` process group over the ranks, with this process's
rank and the group's size.  The caller initialises ``torch.distributed``
(``init_process_group`` with its own address, world size and rank) and
hands the group to the renderer: nothing here reads the default group
behind the caller's back.

``MultiViewRenderer`` renders a batch of cameras: the scene and the IBL
maps are prepared on every rank (each from its own copy of the world), the
views are padded to a multiple of the group's size by repeating the last
camera, and rank r renders the contiguous block ``[r * V_pad / n, (r + 1)
* V_pad / n)`` of them -- the layout ``P(axis)`` gives the reference's
``shard_map`` -- through the single-view frame program: a rank's views,
and the views of every step of a camera path, replay the single-view
Renderer's captured frame on a card (``Renderer._render_params``).
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch
import torch.distributed as dist

from ..config import EngineConfig
from ..passes.frame_graph import Renderer, build_camera_params, stack_params
from ..passes.present import unpack_rgba8
from ..scene.scene_buffers import find_shadow_light
from ..utils import trace

logger = logging.getLogger("mo_renderer_tpu_torch")


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


class _RankRenderer(Renderer):
    """The single-view Renderer of one rank of a group, with collective
    overflow checks: each drain (``check_overflow``, and whenever the
    pending counts pass the lag window) takes the largest counts over the
    group (``all_reduce(MAX)``) and raises on every rank together.  Every
    rank notes its counts at the same calls, so all meet in the
    collective and no rank raises alone while the others wait in it."""

    def __init__(self, config: EngineConfig, group: RankGroup, device):
        super().__init__(config, device)
        self._group = group

    def _drain_lagging(self) -> None:
        self.check_overflow()

    def check_overflow(self) -> None:
        worst = torch.from_numpy(self.drain_overflow()).to(self.device)
        dist.all_reduce(worst, op=dist.ReduceOp.MAX, group=self._group.group)
        self._raise_if_overflow(worst.cpu())


class MultiViewRenderer:
    """Renders a batch of cameras over the ranks of ``group``
    (multi_view.py:47): every rank calls each method with the same world
    and cameras and renders its own block of views on ``device`` (the
    rank's card unless the caller passes another).  Scene preparation is
    the single-view Renderer's."""

    def __init__(self, config: EngineConfig, group: RankGroup,
                 device="cuda"):
        self.config = config
        self.group = group
        self._inner = _RankRenderer(config, group, device)
        self._calls = 0  # the frame id of the tracer's spans of a call

    @property
    def scene(self):
        return self._inner.scene

    @property
    def ibl(self):
        return self._inner.ibl

    def prepare(self, world) -> None:
        self._inner.prepare(world)
        logger.info("multi-view renderer: rank %d of %d", self.group.rank,
                    self.group.size)

    def _sync_topology(self, world) -> None:
        """The inner Renderer's topology sync (frame_graph.py:686): a spawn
        or despawn repacks in place, or falls back to a full prepare.
        Nothing of this class binds what prepare derives; the captured
        frame keys on the inner Renderer's layout (its ``_prepare_count``
        and the scene's shapes), so a full prepare captures again and a
        spawn, a despawn or a move does not."""
        if self._inner.scene is None:
            self.prepare(world)
        self._inner._sync_topology(world)
        self._inner._refresh_transforms()

    def _local(self, items):
        """This rank's block of ``items`` padded to a multiple of the
        group's size with its last element."""
        n = self.group.size
        v_pad = -(-len(items) // n) * n
        padded = list(items) + [items[-1]] * (v_pad - len(items))
        v_local = v_pad // n
        r = self.group.rank
        return padded[r * v_local: (r + 1) * v_local]

    def _render(self, world, params):
        """This rank's frames for its CameraParams ``params``: the
        Renderer's captured frame (the one ``render_device`` replays, on a
        card), with the memoized shadow when every one has the world's
        light."""
        inner = self._inner
        with trace.span("params"):
            quads, has_light = inner._sequence_shadow(world, params)
            stack = stack_params(params)
        frames, overflow = inner._render_params(stack, quads, has_light)
        inner._note_overflow(overflow)
        return frames

    def _call_span(self):
        """The tracer's ``render_views`` span of one call, its frame id the
        call's index."""
        trace.set_frame(self._calls)
        self._calls += 1
        return trace.span("render_views")

    def render_views_device(self, cameras, world):
        """One frame per camera, this rank's block left on its device as
        (V_pad / n, H, W) int32 packed rgba8 bits (multi_view.py:185).
        The view-independent shadow table is memoized once."""
        with self._call_span():
            self._sync_topology(world)
            light_pv, _ = find_shadow_light(world)
            return self._render(world, [
                build_camera_params(c, light_pv, self._inner.device)
                for c in self._local(cameras)])

    def render_view_sequence_device(self, camera_steps, world):
        """K camera-path steps x V views, this rank's views left on its
        device as (K, V_pad / n, H, W) int32 packed rgba8 bits
        (multi_view.py:221): K x V_pad / n replays of the Renderer's one
        captured frame on a card.  ``camera_steps``: a list over steps of
        lists of per-view ``CameraParams``, all the same length.  The
        memoized shadow only when every step and view has the world's
        light."""
        with self._call_span():
            self._sync_topology(world)
            v = len(camera_steps[0])
            if any(len(step) != v for step in camera_steps):
                raise ValueError("ragged camera_steps: every step needs the "
                                 f"same {v} views")
            local = [self._local(step) for step in camera_steps]
            frames = self._render(world, [p for step in local for p in step])
        return frames.reshape(len(local), len(local[0]), *frames.shape[1:])

    def check_overflow(self) -> None:
        """Drain every pending overflow count on every rank, take the
        largest over the group, and raise on every rank if any rank
        dropped geometry (``_RankRenderer``).  Every rank calls it."""
        self._inner.check_overflow()

    def render_views(self, cameras, world) -> np.ndarray:
        """One frame per camera, gathered over the group: (V, H, W, 4)
        uint8 rgba on every rank's host (multi_view.py:270)."""
        block = self.render_views_device(cameras, world)
        parts = [torch.empty_like(block) for _ in range(self.group.size)]
        dist.all_gather(parts, block.contiguous(), group=self.group.group)
        frames = unpack_rgba8(torch.cat(parts)[: len(cameras)])
        self.check_overflow()
        return frames
