"""One spawn, then its despawn, on the JAX Renderer and on the port (CPU,
128x32): both take the incremental path (``_prepare_count`` stays 1), the
port's spawned frame holds the golden bar of tests/test_golden.py:99-107
(mean |diff| < 2/255, fewer than 0.5% of channels above 16/255) against
the JAX frame, and both despawns mask the same triangles.

Both worlds are tests/test_incremental_prepare.py:22-31 without the IBL,
and SSAO is off: the frame's other passes are held against JAX elsewhere,
and the JAX frame's compile is most of this file's time.
"""

import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import __graft_entry__ as graft  # noqa: E402
from mo_renderer_tpu.assets.procedural import procedural_model as jmodel  # noqa: E402
from mo_renderer_tpu.math.transform import Transform as JTransform  # noqa: E402
from mo_renderer_tpu.passes.frame_graph import Renderer as JRenderer  # noqa: E402
from mo_renderer_tpu.scene.components import DirectionalLight as JLight  # noqa: E402
from mo_renderer_tpu.scene.world import World as JWorld  # noqa: E402
from mo_renderer_tpu_torch import Renderer, scenes  # noqa: E402
from mo_renderer_tpu_torch.assets.procedural import procedural_model  # noqa: E402
from mo_renderer_tpu_torch.math.transform import Transform  # noqa: E402
from mo_renderer_tpu_torch.scene.components import DirectionalLight  # noqa: E402
from mo_renderer_tpu_torch.scene.world import World  # noqa: E402

CUBE = dict(base_color=(0.9, 0.6, 0.1, 1))


def _world(W, T, Light, model):
    world = W()
    world.spawn((T.from_xyz(0.0, -0.5, 0.0), model("plane", size=8.0)))
    world.spawn((Light(
        T.from_xyz(5.0, 8.0, 5.0).looking_at((0.0, 0.0, 0.0)),
        (1.0, 1.0, 1.0), 4.0, True,
    ),))
    return world


def test_spawn_then_despawn_matches_jax():
    jcfg = dataclasses.replace(graft._tiny_config(), width=128, height=32,
                               ssao_enabled=False)
    jworld = _world(JWorld, JTransform, JLight, jmodel)
    jworld.insert_resource(graft._camera(jcfg))
    jr = JRenderer(jcfg)
    jr.prepare(jworld)

    cfg = scenes.tiny_config(width=128, height=32, ssao_enabled=False)
    world = _world(World, Transform, DirectionalLight, procedural_model)
    world.insert_resource(scenes.camera(cfg))
    r = Renderer(cfg, "cpu")
    r.prepare(world)
    f0 = r.render(world)

    e = world.spawn((Transform.from_xyz(0.3, 0.4, 0.0),
                     procedural_model("cube", **CUBE)))
    je = jworld.spawn((JTransform.from_xyz(0.3, 0.4, 0.0),
                       jmodel("cube", **CUBE)))
    got = r.render(world).astype(np.int32)
    want = np.asarray(jr.render(jworld)).astype(np.int32)
    assert r._prepare_count == jr._prepare_count == 1
    diff = np.abs(got - want)[..., :3]
    print(f"spawned frame vs JAX: max |diff| {diff.max()} LSB, mean "
          f"{diff.mean():.4f}, {(diff > 16).mean():.4%} > 16")
    assert diff.mean() < 2.0 and (diff > 16).mean() < 0.005
    assert np.abs(got - f0).max() > 0, "spawned cube not rendered"

    # the despawn: the port gives f0 back; both mask the same triangles
    world.despawn(e)
    jworld.despawn(je)
    np.testing.assert_array_equal(r.render(world), f0)
    jr._sync_topology(jworld)
    assert r._prepare_count == jr._prepare_count == 1
    np.testing.assert_array_equal(r.scene.tri_valid.numpy(),
                                  np.asarray(jr.scene.tri_valid))
