"""The port's bench and eval configs (mo_renderer_tpu_torch/{bench,
eval_configs}.py) and the examples' sky, on the CPU at small sizes.

- ``bench.run`` per frame and with ``seq=2`` (the camera-path sequence)
  gives ``bench.py``'s keys (:165-175) with ``backend`` and the port's
  ``card`` and ``scene``, and a non-black frame (``run`` raises on a
  black one).
- ``config_ibl_preprocess`` on a small synthetic sky passes its three
  checks (scripts/eval_configs.py:93-103).
- ``config_sponza`` at 128x64 with a 2 x 2 grid gives its keys.
- ``eval_configs.main`` exits 1 when a config raises, recording the
  error, and 0 when every config that ran succeeded; without
  ``resources/`` the ``pbr_ibl_*`` configs report ``skipped``.
- ``examples.sky`` names the sky file where it exists and falls back to
  the synthetic sky, at the config's IBL sizes.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest  # noqa: E402

from mo_renderer_tpu_torch import bench, eval_configs, scenes  # noqa: E402
from mo_renderer_tpu_torch.config import EngineConfig  # noqa: E402
from mo_renderer_tpu_torch.examples import sky  # noqa: E402

# bench.py:165-175
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "mpixels_per_s",
              "frames", "frames_per_dispatch", "resolution", "backend"}
SMALL_IBL = dict(ibl_cubemap_size=16, ibl_specular_samples=8,
                 ibl_brdf_lut_size=16)


@pytest.fixture
def no_resources(monkeypatch, tmp_path):
    """An empty asset tree: EngineConfig().resource_root points at it."""
    root = tmp_path / "resources"
    root.mkdir()
    monkeypatch.setenv("MO_RESOURCES", str(root))
    return root


@pytest.mark.parametrize("seq", [1, 2])
def test_bench_run(no_resources, seq):
    cfg = scenes.tiny_config(width=128, height=64)
    res = bench.run(cfg, "cpu", frames=2, seq=seq)
    assert set(res) == BENCH_KEYS | {"card", "scene"}
    assert res["metric"] == "pbr_ibl_64p_fps" and res["unit"] == "fps"
    assert res["value"] > 0 and res["resolution"] == "128x64"
    assert res["frames"] == 2 and res["frames_per_dispatch"] == seq
    assert (res["backend"], res["card"], res["scene"]) == (
        "cpu", None, "tiny_world")


def test_config_ibl_preprocess(no_resources):
    res = eval_configs.config_ibl_preprocess(EngineConfig(**SMALL_IBL), "cpu")
    assert res["checks"] == {"mirror_mip_matches_env": True,
                             "irradiance_bounded": True, "finite": True}
    assert res["ok"] and res["sky"] == "synthetic"
    assert (res["cubemap_size"], res["mips"]) == (16, 5)


def test_config_sponza(no_resources):
    cfg = EngineConfig(width=128, height=64, **SMALL_IBL)
    res = eval_configs.config_sponza(cfg, "cpu", frames=1, n_grid=2)
    assert res["fps"] > 0 and res["resolution"] == "128x64"
    assert res["entities"] == 5 and res["sky"] == "synthetic"
    assert res["tris"] == 2 * 1024 + 2 * 12 + 2 and res["binned_cap"] > 0


@pytest.mark.parametrize("only,rc", [
    ("pbr_ibl_720p_ibl_only,sponza_1080p", 1),
    ("pbr_ibl_720p_full", 0),
])
def test_eval_main_exit_code(no_resources, monkeypatch, tmp_path, only, rc):
    def broken(**kw):
        raise RuntimeError("broken config")

    monkeypatch.setattr(eval_configs, "config_sponza", broken)
    monkeypatch.setenv("MO_EVAL_ONLY", only)
    monkeypatch.setenv("MO_EVAL_OUT", str(tmp_path / "eval.json"))
    assert eval_configs.main("cpu") == rc
    res = json.loads((tmp_path / "eval.json").read_text())
    assert res["backend"] == "cpu" and res["card"] is None
    pbr = "pbr_ibl_720p_ibl_only" if rc else "pbr_ibl_720p_full"
    assert res[pbr]["skipped"] == "resources/gltf/man.glb absent"
    if rc:
        assert res["failed"] == ["sponza_1080p"]
        assert res["sponza_1080p"]["error"] == "RuntimeError: broken config"
    else:
        assert res["failed"] == []


def test_sky_prefers_the_file(no_resources):
    cfg = EngineConfig(**SMALL_IBL)
    ibl, name = sky(cfg)
    assert name == "synthetic" and ibl.cubemap_size == 16
    assert (ibl.irradiance_size, ibl.num_specular_mips) == (16, 5)
    env = no_resources / "tex" / "env"
    env.mkdir(parents=True)
    (env / "default_sky.hdr").write_bytes(b"")
    ibl, name = sky(cfg, cache=False)
    assert name == "default_sky.hdr" and ibl.hdr_path == str(
        env / "default_sky.hdr")
    assert not ibl.use_cache
    assert sky(EngineConfig())[0].irradiance_size == 128
