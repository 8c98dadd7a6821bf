"""The Sponza-scale stress scene of the reference project's
``examples/sponza_scale.py`` (``spawn_scene``): a 40-unit textured
plane, an ``n_grid`` x ``n_grid`` grid of alternating cubes and spheres
with distinct materials (colours, heights and roughness from
``default_rng(42)`` in the example's draw order), one shadow-casting sun
and four point lights.  The procedural primitives and the checker
texture are frozen copies of the port's ``assets/procedural.py``; the
sky is a seeded panorama (the example's asset is not shipped).

Everything here is numpy: a recipe is a dict of entities, lights and the
sky, which ``harness.world`` turns into either side's objects."""

from __future__ import annotations

import numpy as np

CHECKER = {"size": 64, "cells": 8, "c0": (220, 220, 220, 255),
           "c1": (60, 60, 60, 255)}


def _primitive(position3, normal3, uv0, indices) -> dict:
    n = position3.shape[0]

    def pad(a):
        return np.concatenate([a.astype(np.float32),
                               np.zeros((n, 1), np.float32)], axis=1)

    return dict(
        indices=np.asarray(indices, np.uint32).reshape(-1),
        position=pad(position3), normal=pad(normal3),
        color=np.ones((n, 4), np.float32),
        uv0=np.asarray(uv0, np.float32),
        uv1=np.asarray(uv0, np.float32).copy(),
        tangent=np.zeros((n, 4), np.float32),
    )


def cube(size: float = 1.0) -> dict:
    """Axis-aligned cube, 24 vertices / 12 triangles, per-face normals."""
    h = size / 2.0
    faces = [
        ((0, 0, 1), (1, 0, 0), (0, 1, 0)),
        ((0, 0, -1), (-1, 0, 0), (0, 1, 0)),
        ((1, 0, 0), (0, 0, -1), (0, 1, 0)),
        ((-1, 0, 0), (0, 0, 1), (0, 1, 0)),
        ((0, 1, 0), (1, 0, 0), (0, 0, -1)),
        ((0, -1, 0), (1, 0, 0), (0, 0, 1)),
    ]
    pos, nrm, uv, idx = [], [], [], []
    for f, (n, u, v) in enumerate(faces):
        n, u, v = map(np.asarray, (n, u, v))
        for su, sv in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
            pos.append(h * (n + su * u + sv * v))
            nrm.append(n)
            uv.append(((su + 1) / 2, (sv + 1) / 2))
        b = 4 * f
        idx += [b, b + 1, b + 2, b, b + 2, b + 3]
    return _primitive(np.array(pos), np.array(nrm, np.float32),
                      np.array(uv), idx)


def plane(size: float = 10.0) -> dict:
    """XZ ground plane facing +Y."""
    h = size / 2.0
    pos = np.array([[-h, 0, -h], [h, 0, -h], [h, 0, h], [-h, 0, h]],
                   np.float32)
    nrm = np.tile(np.array([0, 1, 0], np.float32), (4, 1))
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    return _primitive(pos, nrm, uv, [0, 2, 1, 0, 3, 2])


def sphere(radius: float = 0.5, rings: int = 16, sectors: int = 32) -> dict:
    """Latitude/longitude sphere with smooth normals."""
    phi = np.linspace(0.0, np.pi, rings + 1)
    theta = np.linspace(0.0, 2.0 * np.pi, sectors + 1)
    pp, tt = np.meshgrid(phi, theta, indexing="ij")
    nrm = np.stack([np.sin(pp) * np.cos(tt), np.cos(pp),
                    np.sin(pp) * np.sin(tt)], axis=-1).reshape(-1, 3)
    uv = np.stack([tt / (2.0 * np.pi), pp / np.pi], axis=-1).reshape(-1, 2)
    idx = []
    for r in range(rings):
        for s in range(sectors):
            a = r * (sectors + 1) + s
            b = a + sectors + 1
            idx += [a, a + 1, b, b, a + 1, b + 1]
    return _primitive((radius * nrm).astype(np.float32),
                      nrm.astype(np.float32), uv.astype(np.float32), idx)


def checker_texture(size=64, cells=8, c0=(220, 220, 220, 255),
                    c1=(60, 60, 60, 255)) -> np.ndarray:
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    mask = ((yy * cells // size + xx * cells // size) % 2).astype(bool)
    return np.where(mask[..., None], np.array(c1, np.uint8),
                    np.array(c0, np.uint8)).astype(np.uint8)


PRIMITIVES = {"cube": cube, "plane": plane, "sphere": sphere}


def model(kind: str, *, base_color=(1.0, 1.0, 1.0, 1.0), metallic=0.0,
          roughness=0.5, textured=False, **kw) -> dict:
    """One mesh with a metallic-roughness material: its primitive, the
    material's factors, and its texture (the checker) when ``textured``."""
    return dict(
        primitive=PRIMITIVES[kind](**kw),
        base_color=np.asarray(base_color, np.float32),
        ormn=np.array([1.0, roughness, metallic, 1.0], np.float32),
        textures=[checker_texture(**CHECKER)] if textured else [],
    )


def sky(seed: int, shape=(256, 512)) -> np.ndarray:
    """A (h, w, 3) float32 equirect panorama from ``seed``: a vertical
    gradient between two seeded colours with a seeded warm band, the
    stand-in for the example's ``default_sky.hdr``."""
    rng = np.random.default_rng(seed)
    h, w = shape
    top = np.array([0.3, 0.5, 1.2], np.float32) * rng.uniform(0.8, 1.2, 3)
    bottom = np.array([1.0, 0.8, 0.6], np.float32) * rng.uniform(0.8, 1.2, 3)
    y = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None, None]
    x = np.linspace(0.0, 2.0 * np.pi, w, dtype=np.float32)[None, :, None]
    band = 0.5 * np.exp(-((y - rng.uniform(0.3, 0.5)) / 0.05) ** 2) * (
        1.0 + np.cos(x - rng.uniform(0.0, 2.0 * np.pi)))
    img = top * (1.0 - y) + bottom * y + band * np.array(
        [1.0, 0.7, 0.4], np.float32)
    return np.ascontiguousarray(img.astype(np.float32))


def recipe(seed: int, n_grid: int = 10) -> dict:
    """The scene: entities in the example's spawn order, the lights, the
    stress camera's pose and the sky from ``seed``."""
    entities = [dict(translation=(0.0, 0.0, 0.0),
                     **model("plane", size=40.0, textured=True,
                             roughness=0.8))]
    rng = np.random.default_rng(42)
    for i in range(n_grid):
        for j in range(n_grid):
            x = (i - (n_grid - 1) / 2) * 2.4
            z = (j - (n_grid - 1) / 2) * 2.4
            kind = "cube" if (i + j) % 2 == 0 else "sphere"
            color = tuple(rng.uniform(0.2, 1.0, 3)) + (1.0,)
            m = model(kind, base_color=color,
                      metallic=float((i * n_grid + j) % 3 == 0),
                      roughness=float(0.1 + 0.8 * rng.random()),
                      textured=(i + j) % 5 == 0)
            entities.append(dict(
                translation=(x, 0.5 + 0.8 * rng.random(), z), **m))
    sun = dict(position=(20.0, 30.0, 10.0), target=(0.0, 0.0, 0.0),
               color=(1.0, 0.98, 0.9), intensity=3.0, shadow_width=40.0,
               shadow_height=40.0)
    points = []
    for k in range(4):
        ang = k * np.pi / 2 + 0.4
        points.append(dict(
            position=(8 * np.cos(ang), 3.0, 8 * np.sin(ang)),
            color=[(1, .3, .2), (.2, 1, .3), (.3, .4, 1), (1, 1, .5)][k],
            intensity=8.0))
    # the example's stress camera: 14 units back, 4 up, pitched down 0.2
    camera = dict(yaw=float(np.pi * 0.8), back=14.0, height=4.0,
                  pitch=-0.2)
    return dict(entities=entities, sun=sun, points=points, camera=camera,
                plane_half_extent=20.0, sky=sky(seed))
