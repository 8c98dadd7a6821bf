"""Scene packing: World -> padded tensors on a torch device (port of
``mo_renderer_tpu/scene/scene_buffers.py``: ``SceneBuffers``,
``pack_scene``, ``incremental_repack``, ``refresh_tri_attrs``,
``refresh_transforms`` and ``find_shadow_light``; ``refresh_lights`` is
the port's own).

The packing itself is host-side numpy, identical to the reference.  The
reference uploads with ``jnp.asarray``, which (64-bit types being off in
JAX) turns float64 into float32 and int64 into int32; here every field's
dtype is explicit (``_FIELD_DTYPES``).  Texture stacks and other packed
uint32 words are held as int32 bit patterns.

A spawn or despawn after the pack rewrites only the rows it changes
(``incremental_repack``): the changed row ranges of the padded host
mirrors are copied into the device tensors in place.  The reference's
chunked single-buffer uploads and their pre-compiled program
(``_apply_tail_chunks``, ``warm_incremental``) exist for a slow TPU host
link and an XLA program cache, and are not ported.  No device tensor
shares memory with a host mirror or cache: on the CPU ``Tensor.to``
would alias a numpy array, so every upload copies.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from ..assets import materials as pack_M
from ..assets.default_textures import DefaultTextures
from ..assets.image_io import resize_rgba
from ..assets.materials import DEFAULT_TEXTURE_MAP, pack_material_gpu
from ..assets.model import Model
from ..config import EngineConfig
from ..math.projections import normal_matrix
from ..math.transform import Transform
from ..passes.vertex_stage import pack_triangle_attributes, world_vertex_stage
from ..utils import trace
from .components import DirectionalLight, PointLight, SpotLight

GPU_LIGHT_STRIDE = 20

_FIELD_DTYPES = {
    "position": torch.float32, "normal": torch.float32,
    "color": torch.float32, "uv0": torch.float32, "uv1": torch.float32,
    "tangent": torch.float32, "vertex_mesh": torch.int32,
    "indices": torch.int32, "tri_valid": torch.bool,
    "tri_mesh": torch.int32, "mesh_world": torch.float32,
    "mesh_normal_mat": torch.float32, "mesh_material": torch.int32,
    "materials": torch.float32, "textures": torch.uint8,
    "texture_stack_a": torch.int32, "texture_stack_b": torch.int32,
    "texture_stack_c": torch.int32, "stack_slots": torch.int32,
    "lights": torch.float32, "num_lights": torch.int32,
    "tri_attrs": torch.float32,
}


@dataclasses.dataclass
class SceneBuffers:
    """Padded scene tensors on one device (field meanings as in the
    reference's SceneBuffers)."""

    position: torch.Tensor  # (V, 3) f32 model space
    normal: torch.Tensor  # (V, 3)
    color: torch.Tensor  # (V, 4)
    uv0: torch.Tensor  # (V, 2)
    uv1: torch.Tensor  # (V, 2)
    tangent: torch.Tensor  # (V, 4)
    vertex_mesh: torch.Tensor  # (V,) int32
    indices: torch.Tensor  # (T, 3) int32
    tri_valid: torch.Tensor  # (T,) bool
    tri_mesh: torch.Tensor  # (T,) int32
    mesh_world: torch.Tensor  # (M, 4, 4)
    mesh_normal_mat: torch.Tensor  # (M, 3, 3)
    mesh_material: torch.Tensor  # (M,) int32
    materials: torch.Tensor  # (MAT, MATERIAL_STRIDE) f32
    textures: torch.Tensor  # (L, S, S, 4) uint8 (reference-path array)
    texture_stack_a: torch.Tensor  # (rows, 4*k0) int32 (uint32 bits)
    texture_stack_b: torch.Tensor  # (rows, 4*k1) int32
    texture_stack_c: torch.Tensor  # (rows, 4*k2) int32
    stack_slots: torch.Tensor  # (5,) int32
    lights: torch.Tensor  # (L_pad, 20) f32 GpuLight rows
    num_lights: torch.Tensor  # () int32
    tri_attrs: torch.Tensor  # (T, 35 + n_mat) f32


def to_device_fields(fields: dict, device) -> dict:
    """numpy/tensor fields -> tensors of the port's dtypes on ``device``
    (uint32 words reinterpreted as int32 bit patterns)."""
    out = {}
    for name, dtype in _FIELD_DTYPES.items():
        a = fields[name]
        if isinstance(a, np.ndarray) or np.isscalar(a):
            a = np.array(a, order="C")  # a copy; keeps 0-d arrays 0-d
            if a.dtype == np.uint32:
                a = a.view(np.int32)
            a = torch.from_numpy(a)
        out[name] = a.to(device=device, dtype=dtype)
    return out


def _pad_rows(a: np.ndarray, n: int):
    if a.shape[0] > n:
        raise ValueError(
            f"capacity overflow: need {a.shape[0]} rows, capacity {n} "
            "(raise EngineConfig limits)"
        )
    if a.shape[0] == n:
        return a
    pad = np.zeros((n - a.shape[0],) + a.shape[1:], dtype=a.dtype)
    return np.concatenate([a, pad], axis=0)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class _EntityRecord:
    """Packed placement of one (Transform, Model) entity in the soup.

    ``refs`` keeps the (transform, model) objects alive while the record
    is: identity matching uses their ids, and a freed object's address
    can be reused by a later allocation -- a strong reference makes the
    collision impossible.  Cleared when the record dies (dead records
    are never matched)."""

    key: tuple  # (id(transform), id(model))
    mesh0: int
    v0: int
    t0: int
    n_meshes: int = 0
    nv: int = 0
    nt: int = 0
    alive: bool = True
    refs: tuple | None = None


@dataclasses.dataclass
class _PackState:
    """Host-side packing metadata for incremental topology updates (spawn
    and despawn after the pack).  Every tensor's shape is fixed at pack
    time; an update only rewrites rows (tails of the padded soup, or a
    dead entity's ``tri_valid`` range)."""

    entities: list
    v_count: int
    t_count: int
    m_count: int
    n_materials: int
    n_lights: int
    image_ids: dict  # content hash key -> texture layer
    uniform_rgba: list  # per layer: uniform colour or None
    default_layer: dict  # slot name -> default layer id
    stack_ids: dict  # slot_layers tuple -> stack entry index
    entry_bases: list
    entry_sizes: list
    slot_map: np.ndarray
    host: dict  # padded numpy mirrors of the mutable fields, device dtypes
    # the light components in row order, and what their rows read when the
    # rows were last written (refresh_lights)
    lights: list = dataclasses.field(default_factory=list)
    light_fp: tuple | None = None


def _image_key(img: np.ndarray) -> tuple:
    return (
        img.shape,
        str(img.dtype),
        hashlib.sha1(np.ascontiguousarray(img)).digest(),
    )


def _quad_u32(img: np.ndarray) -> np.ndarray:
    """(S, S, 4) uint8 -> (S*S, 4) uint32 REPEAT quads."""
    se = img.shape[0]
    u32 = (
        img[..., 0].astype(np.uint32)
        | (img[..., 1].astype(np.uint32) << 8)
        | (img[..., 2].astype(np.uint32) << 16)
        | (img[..., 3].astype(np.uint32) << 24)
    )
    xs = np.roll(u32, -1, axis=1)
    ys = np.roll(u32, -1, axis=0)
    xys = np.roll(xs, -1, axis=0)
    return np.stack([u32, xs, ys, xys], axis=-1).reshape(se * se, 4)


def pack_scene(world, config: EngineConfig, device) -> SceneBuffers:
    """Walk the world and build SceneBuffers on ``device``."""
    positions, normals, colors, uv0s, uv1s, tangents, vmesh = (
        [], [], [], [], [], [], []
    )
    tri_indices, tri_mesh = [], []
    mesh_worlds, mesh_normals, mesh_materials = [], [], []
    mesh_sources: list[tuple] = []
    material_rows = []
    material_slot_layers: list[tuple] = []
    row_slot_layers: list[tuple] = []
    stack_ids: dict[tuple, int] = {}
    texture_images: list[np.ndarray] = []

    defaults = world.get_resource(DefaultTextures)
    if defaults is None:
        defaults = DefaultTextures(config.resource_root)

    image_ids: dict[tuple, int] = {}

    def add_texture(img: np.ndarray) -> int:
        key = _image_key(img)
        if key not in image_ids:
            image_ids[key] = len(texture_images)
            texture_images.append(img)
        return image_ids[key]

    default_layer = {
        "base": add_texture(defaults.white),
        "normal": add_texture(defaults.flat_normal),
        "mr": add_texture(defaults.metallic_roughness),
    }
    default_layer["occlusion"] = default_layer["base"]
    default_layer["emissive"] = add_texture(defaults.black)

    entity_records: list[_EntityRecord] = []
    vtx_offset = 0
    tri_offset = 0
    for transform, model in world.query(Transform, Model):
        rec = _EntityRecord(
            key=(id(transform), id(model)), mesh0=len(mesh_worlds),
            v0=vtx_offset, t0=tri_offset, refs=(transform, model),
        )
        entity_world = transform.model_matrix()
        model_layer: dict[int, int] = {}

        def resolve(tex_idx: int, slot: str) -> int:
            if tex_idx == DEFAULT_TEXTURE_MAP:
                return default_layer[slot]
            if tex_idx not in model_layer:
                model_layer[tex_idx] = add_texture(model.textures[tex_idx])
            return model_layer[tex_idx]

        for mesh in model.meshes:
            mesh_id = len(mesh_worlds)
            world_mat = (entity_world @ mesh.world).astype(np.float32)
            mesh_worlds.append(world_mat)
            mesh_normals.append(normal_matrix(world_mat))
            mesh_sources.append((transform, mesh.world))

            mat = mesh.material
            slot_layers = (
                resolve(mat.base_color_texture, "base"),
                resolve(mat.normal_texture, "normal"),
                resolve(mat.surface_properties_texture, "mr"),
                resolve(mat.occlusion_texture, "occlusion"),
                resolve(mat.emissive_texture, "emissive"),
            )
            row = pack_material_gpu(mat, *slot_layers)
            if slot_layers not in stack_ids:
                stack_ids[slot_layers] = len(material_slot_layers)
                material_slot_layers.append(slot_layers)
            mesh.gpu_mat_index = len(material_rows)
            mesh_materials.append(mesh.gpu_mat_index)
            material_rows.append(row)
            row_slot_layers.append(slot_layers)

            prim = mesh.primitive
            n = prim.num_vertices
            positions.append(prim.position[:, :3])
            normals.append(prim.normal[:, :3])
            colors.append(prim.color)
            uv0s.append(prim.uv0)
            uv1s.append(prim.uv1)
            tangents.append(prim.tangent)
            vmesh.append(np.full(n, mesh_id, np.int32))
            tri = prim.indices.reshape(-1, 3).astype(np.int32) + vtx_offset
            tri_indices.append(tri)
            tri_mesh.append(np.full(len(tri), mesh_id, np.int32))
            vtx_offset += n
            tri_offset += len(tri)

        rec.n_meshes = len(mesh_worlds) - rec.mesh0
        rec.nv = vtx_offset - rec.v0
        rec.nt = tri_offset - rec.t0
        entity_records.append(rec)

    if vtx_offset == 0:
        raise ValueError("pack_scene: no (Transform, Model) entities in world")

    v_cat = lambda parts: np.concatenate(parts, axis=0)  # noqa: E731
    position = v_cat(positions).astype(np.float32)
    v_count = position.shape[0]
    t_all = v_cat(tri_indices)
    t_count = t_all.shape[0]
    if v_count > config.max_vertices or t_count > config.max_triangles:
        raise ValueError(
            f"scene too large: {v_count} verts / {t_count} tris exceed config caps"
        )
    v_pad = min(_round_up(v_count, 1024), config.max_vertices)
    t_pad = min(_round_up(t_count, 1024), config.max_triangles)
    tri_valid = np.zeros(t_pad, bool)
    tri_valid[:t_count] = True

    m_count = len(mesh_worlds)
    if m_count > config.max_meshes:
        raise ValueError(
            f"scene too large: {m_count} meshes exceed "
            f"EngineConfig.max_meshes={config.max_meshes}"
        )
    if len(material_rows) > config.max_materials:
        raise ValueError(
            f"scene too large: {len(material_rows)} materials exceed "
            f"EngineConfig.max_materials={config.max_materials}"
        )
    if len(texture_images) > config.max_textures:
        raise ValueError(
            f"scene too large: {len(texture_images)} unique textures "
            f"exceed EngineConfig.max_textures={config.max_textures}"
        )
    m_pad = _round_up(max(m_count, 1), 64)
    mat_pad = _round_up(max(len(material_rows), 1), 64)

    s = config.texture_array_size
    tex_array = np.stack(
        [resize_rgba(img, s) for img in texture_images]
    ).astype(np.uint8)

    quad_cache: dict[tuple[int, int], np.ndarray] = {}

    def quad_of(layer: int, se: int) -> np.ndarray:
        if (layer, se) not in quad_cache:
            quad_cache[(layer, se)] = _quad_u32(
                resize_rgba(texture_images[layer], se)
            )
        return quad_cache[(layer, se)]

    # constant-slot specialization (see the reference)
    uniform_rgba: list = []
    for img in texture_images:
        flat = img.reshape(-1, 4)
        uniform_rgba.append(
            flat[0].astype(np.float32) / 255.0
            if (flat == flat[0]).all()
            else None
        )
    slot_sampled = [
        any(uniform_rgba[slots[slot]] is None for slots in material_slot_layers)
        for slot in range(5)
    ]
    slot_map = np.full(5, -1, np.int32)
    sampled_slots = [slot for slot in range(5) if slot_sampled[slot]]
    for pos, slot in enumerate(sampled_slots):
        slot_map[slot] = pos
    for i, row in enumerate(material_rows):
        for slot in range(5):
            c = uniform_rgba[row_slot_layers[i][slot]]
            if c is not None:
                base = pack_M.MAT_CONST_BASE + 4 * slot
                row[base : base + 4] = c

    def _pow2_at_least(n: int) -> int:
        p = 4
        while p < n:
            p *= 2
        return p

    content_tol = 4
    eff_cache: dict[int, int] = {}

    def _effective_size(layer: int) -> int:
        if layer not in eff_cache:
            img = texture_images[layer]
            nat = _pow2_at_least(max(img.shape[0], img.shape[1]))
            ref = resize_rgba(img, nat).astype(np.int16)
            se = nat
            while se > 4:
                back = resize_rgba(resize_rgba(img, se // 2), nat)
                if np.abs(back.astype(np.int16) - ref).max() > content_tol:
                    break
                se //= 2
            eff_cache[layer] = se
        return eff_cache[layer]

    entry_sizes: list[int] = []
    entry_bases: list[int] = []
    total_rows = 0
    for slots in material_slot_layers:
        native = 4
        for slot in sampled_slots:
            if uniform_rgba[slots[slot]] is None:
                native = max(native, _effective_size(slots[slot]))
        se = min(native, config.max_texture_size)
        entry_bases.append(total_rows)
        entry_sizes.append(se)
        total_rows += se * se
    assert total_rows < (1 << 24), (
        "texture stacks exceed the f32-exact row-offset range; lower "
        "EngineConfig.max_texture_size or dedupe textures"
    )
    for i, row in enumerate(material_rows):
        e = stack_ids[row_slot_layers[i]]
        row[pack_M.MAT_STACK_BASE] = entry_bases[e]
        row[pack_M.MAT_STACK_SIZE] = entry_sizes[e]

    def stack_group(lo, hi):
        group = sampled_slots[lo:hi]
        if not group or not material_slot_layers:
            return np.zeros((1, 4), np.uint32)
        return np.concatenate(
            [
                np.concatenate(
                    [quad_of(slots[slot], entry_sizes[e]) for slot in group],
                    axis=-1,
                )
                for e, slots in enumerate(material_slot_layers)
            ],
            axis=0,
        )

    with trace.span("pack_lights"):
        light_list = _lights_of(world)
        light_rows = [light.gpu_light() for light in light_list]
        if len(light_rows) > config.max_lights:
            raise ValueError(f"too many lights ({len(light_rows)})")
        l_pad = _round_up(max(len(light_rows), 1), 4)
        lights = np.zeros((l_pad, GPU_LIGHT_STRIDE), np.float32)
        for i, row in enumerate(light_rows):
            lights[i] = row
    trace.count("light_rows", len(light_rows))

    # padded host mirrors of the mutable fields, in the device dtypes:
    # incremental_repack appends into their tails and uploads the rows
    host = {
        "position": _pad_rows(position, v_pad),
        "normal": _pad_rows(v_cat(normals).astype(np.float32), v_pad),
        "color": _pad_rows(v_cat(colors).astype(np.float32), v_pad),
        "uv0": _pad_rows(v_cat(uv0s).astype(np.float32), v_pad),
        "uv1": _pad_rows(v_cat(uv1s).astype(np.float32), v_pad),
        "tangent": _pad_rows(v_cat(tangents).astype(np.float32), v_pad),
        "vertex_mesh": _pad_rows(v_cat(vmesh), v_pad),
        "indices": _pad_rows(t_all, t_pad),
        "tri_valid": tri_valid,
        "tri_mesh": _pad_rows(v_cat(tri_mesh), t_pad),
        "mesh_world": _pad_rows(np.stack(mesh_worlds), m_pad),
        "mesh_normal_mat": _pad_rows(np.stack(mesh_normals), m_pad),
        "mesh_material": _pad_rows(np.asarray(mesh_materials, np.int32),
                                   m_pad),
        "materials": _pad_rows(
            np.stack(material_rows).astype(np.float32), mat_pad
        ),
        "lights": lights,
    }
    fields = to_device_fields(  # copies: no tensor aliases a mirror
        {
            **host,
            "textures": tex_array,
            "texture_stack_a": stack_group(0, 2),
            "texture_stack_b": stack_group(2, 4),
            "texture_stack_c": stack_group(4, 5),
            "stack_slots": slot_map,
            "num_lights": np.int32(len(light_rows)),
            "tri_attrs": np.zeros((t_pad, 1), np.float32),  # placeholder
        },
        device,
    )
    scene = refresh_tri_attrs(SceneBuffers(**fields))
    # host-side handles for dynamic transforms (refresh_transforms)
    scene._host_mesh_sources = mesh_sources
    scene._host_trs_cache = _trs_fingerprint(mesh_sources)
    scene._host_pack = _PackState(
        entities=entity_records, v_count=v_count, t_count=t_count,
        m_count=m_count, n_materials=len(material_rows),
        n_lights=len(light_rows), image_ids=image_ids,
        uniform_rgba=uniform_rgba, default_layer=default_layer,
        stack_ids=stack_ids, entry_bases=entry_bases,
        entry_sizes=entry_sizes, slot_map=slot_map, host=host,
        lights=light_list, light_fp=_light_fingerprint(light_list),
    )
    return scene


# the fields an appended entity writes, by the count that indexes their rows
_APPEND_FIELDS = {
    "v": ("position", "normal", "color", "uv0", "uv1", "tangent",
          "vertex_mesh"),
    "t": ("indices", "tri_mesh", "tri_valid"),
    "m": ("mesh_world", "mesh_normal_mat", "mesh_material"),
    "mat": ("materials",),
}
_UV_SET_FIELDS = ("base_color_uv", "normal_uv", "surface_properties_uv",
                  "occlusion_uv", "emissive_uv")


def _write_rows(scene: SceneBuffers, host: dict, name: str, lo: int,
                hi: int) -> None:
    """Copy rows [lo, hi) of the mirror ``name`` into the scene's tensor in
    place.  A blocking copy on the current stream: it lands after every
    frame queued before it, and the mirror may be written again at once."""
    if hi > lo:
        getattr(scene, name)[lo:hi].copy_(torch.from_numpy(host[name][lo:hi]))


def incremental_repack(
    scene: SceneBuffers, world, config: EngineConfig, forbid_uv1: bool = False
) -> SceneBuffers | None:
    """Apply a world topology change (spawn/despawn) to an already-packed
    scene by rewriting only the affected rows of the padded soup.

    - **despawn**: the entity's triangles are masked out of ``tri_valid``
      (its rows stay as dead padding until the next full prepare);
    - **spawn** of a model whose texture CONTENT already exists in the
      packed stacks (another instance of a packed model, or a procedural
      model with default textures): vertices, triangles, meshes and
      materials append into the padded tails.

    Returns a new SceneBuffers (a new object, so that the Renderer's
    shadow memo recomputes) over the same tensors, or None when the change
    cannot be expressed without repacking: new texture content or
    stack-entry combination, a sampled texture in a slot the scene holds
    constant, any capacity overflow, a light-count change, or -- when
    ``forbid_uv1`` -- a new material sampling UV set 1.  The caller then
    runs the full ``pack_scene``.

    Existing entities' mesh and material data is not re-read (as in the
    reference): mutate a packed material and call ``Renderer.prepare``.
    Transforms are the dynamic exception (``refresh_transforms``).
    """
    st = getattr(scene, "_host_pack", None)
    sources = getattr(scene, "_host_mesh_sources", None)
    if st is None or sources is None:
        return None

    # light set: content changes repack in place, count changes re-prepare
    # (the shading loop is specialised to the live count)
    light_list = _lights_of(world)
    if len(light_list) != st.n_lights:
        return None
    light_rows = [light.gpu_light() for light in light_list]

    current = list(world.query(Transform, Model))
    if not current:
        return None  # empty scene: let pack_scene raise its clear error

    # match current entities against packed records by object identity
    by_key: dict[tuple, list[_EntityRecord]] = {}
    for rec in st.entities:
        if rec.alive:
            by_key.setdefault(rec.key, []).append(rec)
    to_append: list[tuple] = []
    matched: set[int] = set()
    for transform, model in current:
        pool = by_key.get((id(transform), id(model)))
        if pool:
            matched.add(id(pool.pop(0)))
        else:
            to_append.append((transform, model))
    dead = [rec for rec in st.entities
            if rec.alive and id(rec) not in matched]

    # --- validate appends against the frozen static layout ---------------
    plans = []  # (transform, model, per-mesh (slot_layers, entry))
    for transform, model in to_append:
        mesh_plans = []
        for mesh in model.meshes:
            mat = mesh.material
            if forbid_uv1 and any(getattr(mat, f) for f in _UV_SET_FIELDS):
                return None  # the fast path samples UV set 0 only
            slot_layers = []
            for tex_idx, slot in (
                (mat.base_color_texture, "base"),
                (mat.normal_texture, "normal"),
                (mat.surface_properties_texture, "mr"),
                (mat.occlusion_texture, "occlusion"),
                (mat.emissive_texture, "emissive"),
            ):
                if tex_idx == DEFAULT_TEXTURE_MAP:
                    slot_layers.append(st.default_layer[slot])
                else:
                    layer = st.image_ids.get(
                        _image_key(model.textures[tex_idx]))
                    if layer is None:
                        return None  # new texture content: stacks must grow
                    slot_layers.append(layer)
            slot_layers = tuple(slot_layers)
            entry = st.stack_ids.get(slot_layers)
            if entry is None:
                return None  # new stack-entry combination
            # a sampled texture in a slot the scene holds constant has no
            # stack position to read from
            for slot in range(5):
                if (st.uniform_rgba[slot_layers[slot]] is None
                        and st.slot_map[slot] < 0):
                    return None
            mesh_plans.append((slot_layers, entry))
        plans.append((transform, model, mesh_plans))

    meshes = [mesh for _, m, _ in plans for mesh in m.meshes]
    h = st.host
    if (
        st.v_count + sum(m.primitive.num_vertices for m in meshes)
        > h["position"].shape[0]
        or st.t_count + sum(len(m.primitive.indices) // 3 for m in meshes)
        > h["indices"].shape[0]
        or st.m_count + len(meshes) > h["mesh_world"].shape[0]
        or st.n_materials + len(meshes) > h["materials"].shape[0]
    ):
        return None  # exceeds the padded capacities: full prepare

    # --- apply: all validation passed; mirrors first, then the device ----
    base = {"v": st.v_count, "t": st.t_count, "m": st.m_count,
            "mat": st.n_materials}
    for rec in dead:
        rec.alive = False
        rec.refs = None  # allow GC; dead records are never matched
        h["tri_valid"][rec.t0 : rec.t0 + rec.nt] = False
        _write_rows(scene, h, "tri_valid", rec.t0, rec.t0 + rec.nt)

    for transform, model, mesh_plans in plans:
        rec = _EntityRecord(
            key=(id(transform), id(model)), mesh0=st.m_count,
            v0=st.v_count, t0=st.t_count, refs=(transform, model),
        )
        entity_world = transform.model_matrix()
        for mesh, (slot_layers, entry) in zip(model.meshes, mesh_plans):
            mesh_id = st.m_count
            world_mat = (entity_world @ mesh.world).astype(np.float32)
            h["mesh_world"][mesh_id] = world_mat
            h["mesh_normal_mat"][mesh_id] = normal_matrix(world_mat)
            sources.append((transform, mesh.world))

            row = pack_material_gpu(mesh.material, *slot_layers)
            for slot in range(5):
                c = st.uniform_rgba[slot_layers[slot]]
                if c is not None:
                    b = pack_M.MAT_CONST_BASE + 4 * slot
                    row[b : b + 4] = c
            row[pack_M.MAT_STACK_BASE] = st.entry_bases[entry]
            row[pack_M.MAT_STACK_SIZE] = st.entry_sizes[entry]
            mesh.gpu_mat_index = st.n_materials
            h["materials"][st.n_materials] = row
            h["mesh_material"][mesh_id] = st.n_materials
            st.n_materials += 1

            prim = mesh.primitive
            n = prim.num_vertices
            v0, t0, nt = st.v_count, st.t_count, len(prim.indices) // 3
            h["position"][v0 : v0 + n] = prim.position[:, :3]
            h["normal"][v0 : v0 + n] = prim.normal[:, :3]
            h["color"][v0 : v0 + n] = prim.color
            h["uv0"][v0 : v0 + n] = prim.uv0
            h["uv1"][v0 : v0 + n] = prim.uv1
            h["tangent"][v0 : v0 + n] = prim.tangent
            h["vertex_mesh"][v0 : v0 + n] = mesh_id
            h["indices"][t0 : t0 + nt] = (
                prim.indices.reshape(-1, 3).astype(np.int32) + v0
            )
            h["tri_mesh"][t0 : t0 + nt] = mesh_id
            h["tri_valid"][t0 : t0 + nt] = True
            st.v_count += n
            st.t_count += nt
            st.m_count += 1
        rec.n_meshes = st.m_count - rec.mesh0
        rec.nv = st.v_count - rec.v0
        rec.nt = st.t_count - rec.t0
        st.entities.append(rec)
    end = {"v": st.v_count, "t": st.t_count, "m": st.m_count,
           "mat": st.n_materials}
    for cls, names in _APPEND_FIELDS.items():
        for name in names:
            _write_rows(scene, h, name, base[cls], end[cls])

    # light content (same count): rewrite the rows in place
    st.lights, st.light_fp = light_list, _light_fingerprint(light_list)
    new_lights = _write_lights(scene, h, light_rows)

    if not (dead or plans or new_lights):
        return scene  # pure reorder / no-op topology bump
    new_scene = dataclasses.replace(scene)
    if plans:
        # tri_attrs reads the appended rows (and no tri_valid: a despawn
        # leaves it as it is)
        new_scene = refresh_tri_attrs(new_scene)
    new_scene._host_mesh_sources = sources
    # carry the OLD TRS cache forward, not a fresh fingerprint: the mesh
    # rows were written from the last-baked worlds, so a transform that
    # moved since then must still look "changed" to the next
    # refresh_transforms (appends also change the fingerprint's length,
    # which forces a re-bake)
    new_scene._host_trs_cache = getattr(scene, "_host_trs_cache", None)
    new_scene._host_pack = st
    return new_scene


def _lights_of(world) -> list:
    """The world's light components in the order of their rows: the
    directional lights, then the point lights, then the spot lights."""
    return [light for comp_type in (DirectionalLight, PointLight, SpotLight)
            for light in world.query(comp_type)]


def _write_lights(scene: SceneBuffers, host: dict, light_rows) -> bool:
    """Write ``light_rows`` into the light table's mirror and the scene's
    tensor in place, if they differ from what it holds; whether they
    did."""
    lights = np.zeros_like(host["lights"])
    for i, row in enumerate(light_rows):
        lights[i] = row
    if np.array_equal(lights, host["lights"]):
        return False
    host["lights"] = lights
    _write_rows(scene, host, "lights", 0, len(lights))
    return True


_NO_ARRAY = b""


def _light_fingerprint(lights) -> tuple:
    """What the lights' rows read, as they are now: the raw bytes of each
    light's translation, rotation, colour and attenuation in one join (an
    element written in place shows as well as an array or a transform
    replaced), and its intensity and spot exponent."""
    arrays = [a for light in lights
              for a in (light.transform.translation, light.transform.rotation,
                        light.color,
                        light.__dict__.get("attenuation", _NO_ARRAY))]
    try:
        raw = b"".join(arrays)
    except (TypeError, BufferError):
        raw = b"".join([np.ascontiguousarray(a) for a in arrays])
    return raw, [(light.intensity, light.__dict__.get("exponent"))
                 for light in lights]


def refresh_lights(scene: SceneBuffers) -> None:
    """Rewrite the packed light rows in place if a light changed since
    they were written (one comparison of ``_light_fingerprint``
    snapshots; a rewrite counts ``light_rewrites``): a moved sun lights
    the frame from where it is, as its shadow map does.  The rows keep
    their tensor, so nothing that reads it is rebuilt."""
    st = getattr(scene, "_host_pack", None)
    if st is None:
        return
    fp = _light_fingerprint(st.lights)
    if fp == st.light_fp:
        return
    trace.count("light_rewrites")
    st.light_fp = fp
    _write_lights(scene, st.host, [light.gpu_light() for light in st.lights])


def refresh_tri_attrs(scene: SceneBuffers) -> SceneBuffers:
    """Recompute the packed per-triangle world-space attribute rows
    (geometry corners + the fast path's material column subset)."""
    slot_map = tuple(int(x) for x in scene.stack_slots.tolist())
    return dataclasses.replace(
        scene,
        tri_attrs=pack_triangle_attributes(
            scene, world_vertex_stage(scene),
            used_cols=pack_M.fast_used_cols(slot_map),
        ),
    )


def _trs_fingerprint(sources):
    """The raw bytes of every source Transform's translation, rotation and
    scale, read in one join of their buffers as they are now, so an
    element written in place shows as well as an array replaced (a
    sequence or a strided view is read through a contiguous copy)."""
    arrays = [a for t, _node_world in sources
              for a in (t.translation, t.rotation, t.scale)]
    try:
        return b"".join(arrays)
    except (TypeError, BufferError):
        return b"".join([np.ascontiguousarray(a) for a in arrays])


def refresh_transforms(scene: SceneBuffers) -> SceneBuffers:
    """Re-bake entity transforms if any Transform changed since the last
    bake (one comparison of ``_trs_fingerprint`` snapshots; a bake counts
    ``transform_bakes``); returns ``scene`` itself (same object) when
    nothing moved."""
    sources = getattr(scene, "_host_mesh_sources", None)
    if not sources:
        return scene
    fp = _trs_fingerprint(sources)
    if fp == getattr(scene, "_host_trs_cache", None):
        return scene
    trace.count("transform_bakes")
    worlds = np.stack(
        [
            (t.model_matrix() @ node_world).astype(np.float32)
            for t, node_world in sources
        ]
    )
    m_pad = scene.mesh_world.shape[0]
    dev = scene.mesh_world.device
    normals = np.stack([normal_matrix(w) for w in worlds])
    # copy=True: on the CPU the tensor would otherwise share memory with
    # ``worlds``, the cache kept below
    new_scene = dataclasses.replace(
        scene,
        mesh_world=torch.from_numpy(_pad_rows(worlds, m_pad)).to(
            dev, copy=True),
        mesh_normal_mat=torch.from_numpy(_pad_rows(normals, m_pad)).to(
            dev, copy=True),
    )
    new_scene = refresh_tri_attrs(new_scene)
    new_scene._host_mesh_sources = sources
    new_scene._host_trs_cache = fp
    # keep the pack state and its mirrors in sync: a later spawn writes
    # mesh rows from the mirror, which would silently revert this move if
    # it were stale
    st = getattr(scene, "_host_pack", None)
    if st is not None:
        st.host["mesh_world"][: len(worlds)] = worlds
        st.host["mesh_normal_mat"][: len(normals)] = normals
        new_scene._host_pack = st
    return new_scene


def find_shadow_light(world):
    """First shadow-casting DirectionalLight; returns (proj_view, found).
    One pass over the entities' component dicts in spawn order, what
    ``world.query(DirectionalLight)`` visits, at a dict lookup an entity."""
    for comps in world.component_dicts():
        light = comps.get(DirectionalLight)
        if light is not None and light.is_shadow_caster:
            return light.proj_view(), True
    return np.eye(4, dtype=np.float32), False
