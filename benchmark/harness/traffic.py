"""The general traffic generator.  A traffic mix is a data file
(``benchmark/traffic/<mix>.json``) of parameters; this module turns it,
the seed and the scene recipe into what a run sends the system, the
same for either loop (``"loop": "frames"`` or ``"views"``):

- ``camera``: the camera's pose at each frame (or path step), one of
  ``CAMERAS`` by its ``kind``:

  - ``"orbit"`` circles the scene's centre at a fixed radius, height
    and pitch, looking at the centre, one turn every ``period_frames``;
    the seed sets the starting phase.  Unless ``sees_sky`` is true,
    set-up checks (``check_orbit``) that every pose sees only the ground
    plane and what stands on it, so no pixel is sky.
  - ``"script"`` is a scripted input (keys held, a button pressed on a
    period, a mouse drag as two sines) fed to ``Camera.update_camera``
    from the recipe's stress camera over a path of ``path_frames``
    steps that loops; the seed sets the step it starts at.

- ``edits``: a list of edit streams, each one of ``EDITS`` by its
  ``kind``, applied to the world before each frame renders:

  - ``"spawn"``: every ``every_frames``-th frame of the window spawns a
    cube (colour, metallic, roughness and a place in front of the camera
    drawn from the seed and the spawn's index), and each is despawned
    ``lifetime_frames`` later.
  - ``"sun"``: the shadow-casting sun turns about the vertical axis
    through its target once every ``period_frames``, its elevation
    swinging between the two ends of ``elevation`` (radians); the seed
    sets the starting azimuth.  Every frame moves it, so the shadow map
    is drawn anew every frame.

- ``timer_step_s``: the fixed step of the Timer, so that no pose depends
  on the speed of the run.

The loop itself is closed: a frame (or a call of views) is sent when the
previous one has come back, as an app's frame loop does.  The reference
renders the world as ``Edits.build`` makes it at a frame, from the pose
``pose`` gives there."""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from ..reference.plain.math import quat


@dataclasses.dataclass
class Stage:
    """What the traffic needs to know of the scene and the screen."""

    recipe: dict
    fov: float
    aspect: float
    near: float
    step_s: float


def stage(run, api) -> Stage:
    """The Stage of ``run``'s recipe and configuration (camera constants
    from ``api``'s Camera)."""
    conf = run.cell.config
    cam = api.Camera()
    return Stage(run.recipe, cam.fov(), conf["width"] / conf["height"],
                 cam.near_p(), float(run.cell.traffic["timer_step_s"]))


def _forward(yaw: float, pitch: float) -> np.ndarray:
    """The camera's unit forward for a yaw about +Y then a pitch about its
    local X (positive looks down): (sin yaw cos p, -sin p, cos yaw cos p)."""
    return np.array([math.sin(yaw) * math.cos(pitch), -math.sin(pitch),
                     math.cos(yaw) * math.cos(pitch)])


def corner_rays(yaw, pitch, fov, aspect) -> np.ndarray:
    """(4, 3) unit directions of the frustum's corner rays."""
    f = _forward(yaw, pitch)
    right = np.cross(f, [0.0, 1.0, 0.0])
    right /= np.linalg.norm(right)
    up = np.cross(right, f)
    th = math.tan(fov / 2.0)
    rays = [f + th * (sx * aspect * right + sy * up)
            for sx in (-1, 1) for sy in (-1, 1)]
    return np.array([r / np.linalg.norm(r) for r in rays])


def _ground_point(pos, forward, reach: float = 10.0) -> np.ndarray:
    """Where a ray from ``pos`` along ``forward`` meets the ground, or
    the point ``reach`` ahead dropped to the ground where it never does."""
    pos, forward = np.asarray(pos, float), np.asarray(forward, float)
    if forward[1] < -1e-3:
        return pos + forward * (pos[1] / -forward[1])
    p = pos + reach * forward
    return np.array([p[0], 0.0, p[2]])


class Orbit:
    """The orbit camera of a traffic's ``camera`` block: ``radius`` from
    the centre at ``height``, looking at the centre's vertical axis,
    pitched down by ``pitch``."""

    def __init__(self, spec: dict, seed: int, st: Stage):
        self.height = float(spec["height"])
        self.pitch = float(spec["pitch"])
        self.period = int(spec["period_frames"])
        self.radius = float(spec["radius"])
        self.phase = np.random.default_rng([seed, 1]).uniform(0.0, 2 * np.pi)
        if not spec.get("sees_sky", False):
            half = float(st.recipe["plane_half_extent"])
            check_orbit(self, half - float(spec["margin"]), half, st.fov,
                        st.aspect, st.near)

    def theta(self, i: int) -> float:
        return self.phase + 2.0 * math.pi * (i % self.period) / self.period

    def yaw(self, i: int) -> float:
        """The yaw whose forward, (sin yaw, 0, cos yaw), points from the
        eye to the centre's axis."""
        t = self.theta(i)
        return math.atan2(-math.cos(t), -math.sin(t))

    def pose(self, i: int):
        """(position (3,), rotation quaternion) at frame ``i``."""
        t = self.theta(i)
        pos = np.array([self.radius * math.cos(t), self.height,
                        self.radius * math.sin(t)], np.float32)
        rot = quat.mul(quat.from_rotation_y(self.yaw(i)),
                       quat.from_rotation_x(self.pitch))
        return pos, rot

    def ground_ahead(self, i: int) -> np.ndarray:
        """Where the view's centre ray meets the ground at frame ``i``."""
        return _ground_point(self.pose(i)[0],
                             _forward(self.yaw(i), self.pitch))


def check_orbit(orbit, half, plane_half, fov, aspect, near) -> None:
    """Raise unless every pose of ``orbit`` sees only the ground plane
    and what stands on it: its four corner rays meet the ground within
    ``half`` of the centre on both axes, and every corner of the plane
    (``plane_half`` from the centre) lies in front of the eye by more
    than ten near distances -- the rasterizer culls a triangle with a
    corner behind the eye, and the plane is two triangles."""
    corners = np.array([[sx * plane_half, 0.0, sz * plane_half]
                        for sx in (-1, 1) for sz in (-1, 1)])
    for i in range(orbit.period):
        pos, _ = orbit.pose(i)
        rays = corner_rays(orbit.yaw(i), orbit.pitch, fov, aspect)
        if np.any(rays[:, 1] >= 0.0):
            raise ValueError(f"orbit: frame {i} sees above the horizon")
        hit = pos + rays * (pos[1] / -rays[:, 1])[:, None]
        if np.abs(hit[:, [0, 2]]).max() > half:
            raise ValueError(f"orbit: frame {i} sees past the plane")
        depth = (corners - pos) @ _forward(orbit.yaw(i), orbit.pitch)
        if depth.min() <= 10.0 * near:
            raise ValueError(f"orbit: a plane corner is behind the eye at "
                             f"frame {i}")


class Script:
    """The scripted input of a traffic's ``camera`` block (the reference
    project's ``scripted_input`` pattern, in parameters), fed to ``api``'s
    Timer and ``Camera.update_camera`` (the plain copy's unless given)
    from the recipe's stress camera; the poses of the ``path_frames``
    steps, looped."""

    def __init__(self, spec: dict, seed: int, st: Stage, api=None):
        if api is None:
            from . import world

            api = world.reference_api()
        self.spec = spec
        self.period = int(spec["path_frames"])
        self.phase = int(np.random.default_rng([seed, 2]).integers(
            0, self.period))
        c = st.recipe["camera"]
        d = np.array([math.sin(c["yaw"]), 0.0, math.cos(c["yaw"])])
        cam = api.Camera(
            position=tuple(-c["back"] * d + np.array([0.0, c["height"],
                                                      0.0])),
            rotation=api.quat.mul(api.quat.from_rotation_y(c["yaw"]),
                                  api.quat.from_rotation_x(c["pitch"])))
        w = api.World()
        timer = api.Timer()
        timer.fixed_step = st.step_s
        inp = api.Input()
        for res in (timer, inp, cam):
            w.insert_resource(res)
        self.poses = []
        for step in range(self.period):
            self.apply(api, inp, step)
            api.Timer.update_timer(w)
            api.Camera.update_camera(w)
            self.poses.append((np.array(cam.transform.translation, copy=True),
                               np.array(cam.transform.rotation, copy=True),
                               np.array(cam.direction(), copy=True)))

    def apply(self, api, input_res, step: int) -> None:
        """Press, release and move on ``input_res`` (the side's Input) as
        the script says for path step ``step``."""
        s = self.spec
        for key in s["hold"]:
            input_res.press(api.EInputButton.key(key))
        p = s["press"]
        if step % p["period"] == p["at"]:
            input_res.press(getattr(api.EInputButton, p["button"]))
        m = s["mouse"]
        input_res.move_mouse(m["ax"] * math.sin(step * m["fx"]),
                             m["ay"] * math.cos(step * m["fy"]))
        w = s["window"]
        key = api.EInputButton.key(w["key"])
        if w["from"] <= step % w["period"] < w["to"]:
            input_res.press(key)
        else:
            input_res.release(key)

    def pose(self, i: int):
        pos, rot, _ = self.poses[(self.phase + i) % self.period]
        return pos, rot

    def ground_ahead(self, i: int) -> np.ndarray:
        pos, _, forward = self.poses[(self.phase + i) % self.period]
        return _ground_point(pos, forward)


CAMERAS = {"orbit": Orbit, "script": Script}


def camera(spec: dict, seed: int, st: Stage):
    """The camera of a traffic's ``camera`` block, by its ``kind``."""
    if spec["kind"] not in CAMERAS:
        raise ValueError(f"traffic: no camera kind {spec['kind']!r} "
                         f"(have {', '.join(CAMERAS)})")
    return CAMERAS[spec["kind"]](spec, seed, st)


class Spawns:
    """The spawn/despawn stream of a traffic's ``edits``."""

    def __init__(self, spec: dict, seed: int, st: Stage, cam):
        self.spec = spec
        self.seed = seed
        self.camera = cam
        self.every = int(spec["every_frames"])
        self.lifetime = int(spec["lifetime_frames"])
        if not 0 < self.lifetime < self.every:
            raise ValueError("edits: lifetime_frames must lie in "
                             "(0, every_frames)")

    def at(self, i: int):
        """The edits of window frame ``i``: [("spawn", k)] or
        [("despawn", k)] or [] (k: the spawn's index)."""
        if i < 0:
            return []
        if i % self.every == 0:
            return [("spawn", i // self.every)]
        if i % self.every == self.lifetime:
            return [("despawn", i // self.every)]
        return []

    def live(self, i: int) -> list[int]:
        """The spawns alive while frame ``i`` renders (its own edit
        applied)."""
        if i < 0:
            return []
        k = i // self.every
        return [k] if i % self.every < self.lifetime else []

    def key(self, i: int):
        return tuple(self.live(i))

    def entity(self, k: int, ground=None) -> dict:
        """Spawn ``k``'s cube: size, material and its place (an offset from
        ``ground``, by default where the view's centre meets the ground at
        its spawn frame, lifted), all drawn from the seed and ``k``."""
        from ..scenes import sponza_grid

        if ground is None:
            ground = self.camera.ground_ahead(k * self.every)
        s = self.spec
        rng = np.random.default_rng([self.seed, 3, k])
        color = tuple(rng.uniform(*s["base_color"], 3)) + (1.0,)
        m = sponza_grid.model("cube", size=float(s["size"]),
                              base_color=color,
                              metallic=float(rng.uniform(*s["metallic"])),
                              roughness=float(rng.uniform(*s["roughness"])))
        off = rng.uniform(-1.0, 1.0, 2) * np.array(s["offset"], float)
        y = rng.uniform(*s["height"])
        return dict(translation=(float(ground[0] + off[0]), float(y),
                                 float(ground[2] + off[1])), **m)

    def apply(self, api, world_, i: int, spawned: dict) -> None:
        """Frame ``i``'s edits on a live world; ``spawned`` maps a spawn's
        index to its Entity."""
        from . import world

        for op, k in self.at(i):
            if op == "spawn":
                spawned[k] = world.spawn_entity(api, world_, self.entity(k))
            else:
                world_.despawn(spawned.pop(k))

    def build(self, api, world_, i: int) -> None:
        """The spawns alive at frame ``i``, into a world that has none."""
        from . import world

        for k in self.live(i):
            world.spawn_entity(api, world_, self.entity(k))


class Sun:
    """The turning sun of a traffic's ``edits``: the recipe's shadow
    caster, at its distance from its target, turned about the vertical
    axis through the target."""

    def __init__(self, spec: dict, seed: int, st: Stage, cam):
        sun = st.recipe["sun"]
        self.target = np.array(sun["target"], float)
        self.distance = float(np.linalg.norm(
            np.array(sun["position"], float) - self.target))
        self.period = int(spec["period_frames"])
        self.lo, self.hi = (float(x) for x in spec["elevation"])
        self.phase = np.random.default_rng([seed, 4]).uniform(0.0, 2 * np.pi)

    def at(self, i: int):
        return [("sun", i)]

    def position(self, i: int) -> tuple:
        t = 2.0 * math.pi * (i % self.period) / self.period
        el = self.lo + (self.hi - self.lo) * 0.5 * (1.0 + math.cos(t))
        az = self.phase + t
        d = np.array([math.cos(el) * math.cos(az), math.sin(el),
                      math.cos(el) * math.sin(az)])
        return tuple(float(x) for x in self.target + self.distance * d)

    def key(self, i: int):
        return self.position(i)

    def apply(self, api, world_, i: int, spawned=None) -> None:
        for light in world_.query(api.DirectionalLight):
            if light.is_shadow_caster:
                light.transform = api.Transform.from_xyz(
                    *self.position(i)).looking_at(tuple(self.target))

    build = apply


EDITS = {"spawn": Spawns, "sun": Sun}


class Edits:
    """All the edit streams of a traffic's ``edits`` list."""

    def __init__(self, specs, seed: int, st: Stage, cam):
        for s in specs or ():
            if s["kind"] not in EDITS:
                raise ValueError(f"traffic: no edit kind {s['kind']!r} "
                                 f"(have {', '.join(EDITS)})")
        self.streams = [EDITS[s["kind"]](s, seed, st, cam)
                        for s in specs or ()]

    def __bool__(self):
        return bool(self.streams)

    def of(self, kind):
        """The first stream of class ``kind``, or None."""
        return next((s for s in self.streams if isinstance(s, kind)), None)

    def at(self, i: int) -> list:
        """Frame ``i``'s edits, [(op, arg)], of every stream."""
        return [op for s in self.streams for op in s.at(i)]

    def apply(self, api, world_, i: int, spawned: dict) -> None:
        for s in self.streams:
            s.apply(api, world_, i, spawned)

    def build(self, api, world_, i: int) -> None:
        """The world as edited at frame ``i``, from the recipe's."""
        for s in self.streams:
            s.build(api, world_, i)

    def key(self, i: int) -> tuple:
        """What tells the world at frame ``i`` from the world at another
        (equal keys, equal worlds)."""
        return tuple(s.key(i) for s in self.streams)


def schedule(run, api):
    """(camera, Edits) of ``run``'s traffic."""
    tr = run.cell.traffic
    st = stage(run, api)
    cam = camera(tr["camera"], run.seed, st)
    return cam, Edits(tr.get("edits"), run.seed, st, cam)
