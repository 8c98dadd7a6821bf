"""The same recipe, handed to either side: ``port_api()`` names the
port's classes, ``reference_api()`` the plain reference's copies, and
``build_world`` spawns a recipe's entities and lights into a world of
either.  The harness hands the port only these objects, through its
public API (``World.spawn``, ``Model``, the light components)."""

from __future__ import annotations

import importlib
import os
import types

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def _api(root: str) -> types.SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    model = mod("assets.model")
    comps = mod("scene.components")
    return types.SimpleNamespace(
        World=mod("scene.world").World,
        Transform=mod("math.transform").Transform,
        quat=mod("math.quat"),
        Camera=mod("scene.camera").Camera,
        Input=mod("scene.input").Input,
        EInputButton=mod("scene.input").EInputButton,
        Timer=mod("scene.timer").Timer,
        Model=model.Model, Mesh=model.Mesh, MeshPrimitive=model.MeshPrimitive,
        Material=mod("assets.materials").GltfMaterialCPU,
        DirectionalLight=comps.DirectionalLight, PointLight=comps.PointLight,
        DefaultTextures=mod("assets.default_textures").DefaultTextures,
        EngineConfig=mod("config").EngineConfig,
    )


def port_api():
    return _api("mo_renderer_tpu_torch")


def reference_api():
    return _api("benchmark.reference.plain")


def make_model(api, m: dict):
    """A one-mesh Model of ``api`` from a recipe's model dict."""
    prim = api.MeshPrimitive(**{k: np.array(v, copy=True)
                                for k, v in m["primitive"].items()})
    mat = api.Material(base_color_factor=np.array(m["base_color"],
                                                  np.float32))
    mat.ormn = np.array(m["ormn"], np.float32)
    textures = [np.array(t, copy=True) for t in m["textures"]]
    if textures:
        mat.base_color_texture = 0
    return api.Model(meshes=[api.Mesh(primitive=prim, material=mat)],
                     textures=textures)


def spawn_entity(api, world, ent: dict):
    """Spawn one recipe entity (a model at a translation); its Entity."""
    return world.spawn((api.Transform.from_xyz(*ent["translation"]),
                        make_model(api, ent)))


def build_world(api, recipe: dict):
    """A world of ``api`` holding the recipe's entities and lights
    (``populate``)."""
    world = api.World()
    populate(api, world, recipe)
    return world


def populate(api, world, recipe: dict) -> None:
    """Spawn the recipe's entities and lights into ``world``, in the
    recipe's order, and give it the built-in default textures."""
    # a resource root with no tex/ directory: the built-in textures
    world.insert_resource(api.DefaultTextures(HERE))
    for ent in recipe["entities"]:
        spawn_entity(api, world, ent)
    sun = recipe["sun"]
    world.spawn((api.DirectionalLight(
        api.Transform.from_xyz(*sun["position"]).looking_at(sun["target"]),
        sun["color"], sun["intensity"], True,
        shadow_width=sun["shadow_width"],
        shadow_height=sun["shadow_height"]),))
    for p in recipe["points"]:
        world.spawn((api.PointLight(api.Transform.from_xyz(*p["position"]),
                                    color=p["color"],
                                    intensity=p["intensity"]),))
