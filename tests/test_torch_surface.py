"""The port's public surface against the JAX package's: the package's
top-level names, ``utils`` and the oracle rasterizer
(mo_renderer_tpu_torch/{__init__,utils/__init__,kernels/raster_reference}.py).

- Every name of ``mo_renderer_tpu.__all__`` resolves in
  ``mo_renderer_tpu_torch`` to the port's own class, from the port's copy
  of the module the JAX package names for it; ``__version__`` is equal.
- ``clamp``, the tracer's span (``utils.trace``, which replaced
  ``log_span``) and ``profile_trace`` (through
  ``App.run(profile_dir=...)``, which writes a torch.profiler trace).
- ``rasterize_reference`` against the JAX ``rasterize_reference`` on the
  same setup rows (the JAX setup's, as numpy), at 64x32: ids exactly
  equal and depth within atol 1e-6 (the bars of
  tests/test_rasterizer.py:138-139), barycentrics within rtol 2e-3 /
  atol 1e-4 on covered pixels (the per-pixel planes' bar,
  tests/test_attr_planes.py); and against the port's own tile rasterizer
  in full mode (K6's plain version) on the tiny scene, at the same bars.
"""

import glob
import importlib
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import mo_renderer_tpu  # noqa: E402
import mo_renderer_tpu_torch as port  # noqa: E402
from mo_renderer_tpu.kernels import raster_reference as JRR  # noqa: E402
from mo_renderer_tpu.kernels import raster_setup as JRS  # noqa: E402
from mo_renderer_tpu.utils import clamp as j_clamp  # noqa: E402
from mo_renderer_tpu_torch import scenes, utils  # noqa: E402
from mo_renderer_tpu_torch.kernels import raster_reference as RR  # noqa: E402
from mo_renderer_tpu_torch.kernels import raster_setup as RS  # noqa: E402
from mo_renderer_tpu_torch.kernels import rasterizer as R  # noqa: E402
from mo_renderer_tpu_torch.passes.frame_graph import _bin  # noqa: E402


@pytest.mark.parametrize("name", mo_renderer_tpu.__all__)
def test_top_level_name_is_the_ports_own(name):
    val = getattr(port, name)
    mod = importlib.import_module(
        "mo_renderer_tpu_torch" + mo_renderer_tpu._EXPORTS[name])
    assert val is getattr(mod, name)
    assert val.__module__.startswith("mo_renderer_tpu_torch.")
    assert name in port.__all__


def test_version_and_port_names():
    assert port.__version__ == mo_renderer_tpu.__version__
    assert port.Renderer.__module__ == "mo_renderer_tpu_torch.passes.frame_graph"
    assert {"App", "Renderer", "RenderPass"} <= set(port.__all__)
    with pytest.raises(AttributeError):
        port.NotAName  # noqa: B018


@pytest.mark.parametrize("value,expected", [(-1, 0), (0.5, 0.5), (3, 2)])
def test_clamp(value, expected):
    assert utils.clamp(value, 0, 2) == expected
    assert j_clamp(value, 0, 2) == expected


def test_log_span():
    """A timed, named span: the tracer's ``span`` (``log_span``, which
    only logged one, is gone)."""
    assert not hasattr(utils, "log_span")
    n = len(utils.trace.snapshot()["spans"])
    utils.trace.enable()
    try:
        with utils.trace.span("pack"):
            pass
    finally:
        utils.trace.disable()
    (rec,) = utils.trace.snapshot()["spans"][n:]
    assert rec[0] == "pack" and rec[4] >= rec[3]


def test_profile_trace_through_app_run(tmp_path):
    cfg = scenes.tiny_config(width=128, height=32)
    app = port.App.new(config=cfg, device="cpu")
    app.world = scenes.tiny_world()
    app.insert_resource(scenes.camera(cfg))
    frame = app.run(num_frames=1, profile_dir=str(tmp_path / "trace"))
    assert frame.shape == (32, 128, 4)
    traces = glob.glob(str(tmp_path / "trace" / "*.pt.trace.json"))
    assert len(traces) == 1 and os.path.getsize(traces[0]) > 0
    # the tracer was on over the loop: its spans are in the trace
    text = open(traces[0]).read()
    assert '"mo::render_device"' in text and '"mo::pass::raster"' in text
    assert not utils.trace.enabled()


def _assert_oracle_equal(port_out, ref_out, what):
    tri, z, b0, b1 = (np.asarray(a) for a in port_out)
    t_r, z_r, b0_r, b1_r = (np.asarray(a) for a in ref_out)
    cov = t_r >= 0
    print(f"{what}: {int((tri != t_r).sum())} id mismatches, covered "
          f"{cov.mean():.3f}, depth max |diff| {np.abs(z - z_r).max():.3g}")
    assert cov.sum() > 100
    np.testing.assert_array_equal(tri, t_r)
    np.testing.assert_allclose(z, z_r, atol=1e-6, rtol=0)
    for b, b_r in ((b0, b0_r), (b1, b1_r)):
        np.testing.assert_allclose(b[cov], b_r[cov], rtol=2e-3, atol=1e-4)


@pytest.mark.parametrize("seed,n_tri,cull", [(42, 50, False), (3, 120, True)])
def test_oracle_matches_jax_oracle(seed, n_tri, cull):
    """A random soup's setup rows at 64x32 (tests/test_rasterizer.py's
    soup), through both oracles; the chunk is cut small so that the rows
    span several chunks."""
    w, h = 64, 32
    rng = np.random.RandomState(seed)
    pts = rng.uniform([0, 0], [w, h], size=(n_tri * 3, 2))
    zs = rng.uniform(0.05, 0.95, size=n_tri * 3)
    clip = np.stack([pts[:, 0] / w * 2.0 - 1.0, pts[:, 1] / h * 2.0 - 1.0,
                     zs, np.ones(n_tri * 3)], axis=-1).astype(np.float32)
    idx = np.arange(n_tri * 3, dtype=np.int32).reshape(n_tri, 3)
    setup = JRS.triangle_setup(jnp.asarray(clip), jnp.asarray(idx),
                               jnp.ones(n_tri, bool), w, h,
                               cull_backface=cull)
    ref = JRR.rasterize_reference(setup, w, h)
    rows = RS.TriangleSetup(torch.tensor(np.asarray(setup.tri_data)),
                            torch.tensor(np.asarray(setup.bbox)))
    old = RR.CHUNK_ELEMENTS
    RR.CHUNK_ELEMENTS = 16 * w * h
    try:
        out = RR.rasterize_reference(rows, w, h)
    finally:
        RR.CHUNK_ELEMENTS = old
    assert out[0].dtype == torch.int32 and out[1].dtype == torch.float32
    _assert_oracle_equal(out, ref, f"soup {seed}")


def test_oracle_matches_tile_rasterizer_full_mode():
    """The tiny scene from the camera at 256x128: the oracle equals the
    port's binned rasterizer in full mode (K6's plain version), the pair
    that chip_smoke.py holds on the card."""
    cfg = scenes.tiny_config()
    world = scenes.tiny_world()
    world.insert_resource(scenes.camera(cfg))
    r = port.Renderer(cfg, "cpu")
    r.prepare(world)
    params, _ = r.frame_params(world)
    setup = RS.triangle_setup_from_attrs(
        r.scene.tri_attrs, r.scene.tri_valid, params["proj_view"],
        cfg.width, cfg.height)
    binned = _bin(setup, cfg.width, cfg.height, r._binned_cap)
    assert binned.overflow == 0
    full = R.rasterize(binned, width=cfg.width, height=cfg.height)
    _assert_oracle_equal(RR.rasterize_reference(setup, cfg.width, cfg.height),
                         full, "tiny scene vs full mode")
