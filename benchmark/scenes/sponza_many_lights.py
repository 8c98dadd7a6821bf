"""The Sponza-scale scene lit by many point lights, after the many-light
Sponza tests of tiled deferred shading (Lauritzen, "Deferred Rendering
for Current and Future Rendering Pipelines", SIGGRAPH 2010, Beyond
Programmable Shading: Sponza lit by up to 1024 point lights).

``sponza_grid.recipe`` whole -- its entities, sun, sky, camera and plane
-- with its four point lights replaced by ``n_points`` drawn from a fixed
generator, the same on every seed as the grid is: x and z uniform over
the plane less half a unit, heights uniform in [0.3, 4], a random hue at
saturation 0.5-1 and value 1, and ``32 / n_points`` intensity each, the
stock four lights' total (4 x 8).  The engine's point light has no range
(attenuation 1 / (1 + 0.09 d + 0.032 d^2)), so every light reaches every
pixel and the frame sums all of them."""

from __future__ import annotations

import numpy as np

from . import sponza_grid

# the draws of the lights: the same on every seed
LIGHTS_SEED = 1024
# the stock four lights' total intensity, spread over the points
TOTAL_INTENSITY = 4 * 8.0


def hue_color(hue, saturation) -> np.ndarray:
    """(..., 3) RGB of HSV colours at value 1."""
    k = (np.array([5.0, 3.0, 1.0]) + np.asarray(hue)[..., None] * 6.0) % 6.0
    return 1.0 - np.asarray(saturation)[..., None] * np.clip(
        np.minimum(k, 4.0 - k), 0.0, 1.0)


def points(n_points: int, half_extent: float) -> list:
    """The ``n_points`` point lights over a plane of ``half_extent``."""
    rng = np.random.default_rng(LIGHTS_SEED)
    reach = half_extent - 0.5
    xz = rng.uniform(-reach, reach, (n_points, 2))
    height = rng.uniform(0.3, 4.0, n_points)
    color = hue_color(rng.uniform(0.0, 1.0, n_points),
                      rng.uniform(0.5, 1.0, n_points))
    intensity = TOTAL_INTENSITY / n_points
    return [dict(position=(float(xz[k, 0]), float(height[k]),
                           float(xz[k, 1])),
                 color=tuple(float(c) for c in color[k]),
                 intensity=intensity) for k in range(n_points)]


def recipe(seed: int, n_grid: int = 10, n_points: int = 1024) -> dict:
    """``sponza_grid.recipe(seed, n_grid)`` with ``n_points`` point
    lights in place of its four."""
    rec = sponza_grid.recipe(seed, n_grid)
    rec["points"] = points(n_points, float(rec["plane_half_extent"]))
    return rec
