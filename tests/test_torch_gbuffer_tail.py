"""The fast path's G-buffer tail (``passes/gbuffer.py`` ``gbuffer_tail``,
whose card kernel is K10, ``csrc/gbuffer.cu``) on the CPU.

- Against the JAX reference's ``_texture_and_assemble`` (and, for the
  megakernel's planes, ``gbuffer_pass_from_planes``) on random inputs laid
  out as each of the tail's five input sources has them, with every slot
  sampled, with constant slots, and with none sampled.  Bar: each plane
  within rtol 1e-5 / atol 1e-5 (the normal atol 1e-4, as in
  tests/test_torch_gbuffer.py), the mask equal.
- The host side of K10: the argument block ``tail_args`` packs for each
  source (channel pointers and strides of views, the slot kinds, the
  material columns), its ctypes layout against the C struct, what it
  refuses, and that a CPU tensor never loads the library.
- The per-unit nvcc flags and ``max_offset`` of ``kernels/_build.py``.

The kernel itself runs only on a card (tests/test_torch_cuda.py,
chip_smoke.py phase 2).
"""

import ctypes
import os
import re
import sys
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from mo_renderer_tpu.passes import gbuffer as JG  # noqa: E402
from mo_renderer_tpu_torch.assets import materials as M  # noqa: E402
from mo_renderer_tpu_torch.kernels import _build  # noqa: E402
from mo_renderer_tpu_torch.passes import gbuffer as G  # noqa: E402

SOURCES = chip_smoke.GBUFFER_SOURCES
SLOT_MAPS = [(0, 1, 2, 3, 4), (0, -1, -1, -1, -1), (-1, 0, -1, 1, -1),
             (-1, -1, -1, -1, -1)]


def _np(t):
    return np.asarray(t.detach().numpy() if isinstance(t, torch.Tensor)
                      else t)


def _reference(args):
    """The JAX package's tail on the same inputs."""
    tri, z, src, pv, prev_pv, scene, slot_map, _ = args
    jscene = types.SimpleNamespace(**{
        k: jnp.asarray(_np(getattr(scene, k))) for k in (
            "materials", "texture_stack_a", "texture_stack_b",
            "texture_stack_c")})
    params = {"proj_view": jnp.asarray(_np(pv)),
              "prev_proj_view": jnp.asarray(_np(prev_pv))}
    jtri, jz = jnp.asarray(_np(tri)), jnp.asarray(_np(z))
    if src.mat_plane is not None:
        attrs = [jnp.asarray(_np(p)) for f in (
            "world_pos", "n_in", "t_in", "bt_in", "uv0")
            for p in getattr(src, f)]
        return JG.gbuffer_pass_from_planes(
            jtri, jz, attrs, jnp.asarray(_np(src.mat_plane)),
            jnp.asarray(_np(src.handed)), jscene, params, slot_map)

    def vec(x):
        return jnp.asarray(_np(G._vec(x)))

    wp = vec(src.world_pos)
    wp1 = jnp.concatenate([wp, jnp.ones_like(wp[..., :1])], -1)
    velocity = (JG._ndc01(wp1 @ params["proj_view"].T)
                - JG._ndc01(wp1 @ params["prev_proj_view"].T))
    return JG._texture_and_assemble(
        jtri >= 0, jz, wp, vec(src.n_in), vec(src.t_in), vec(src.bt_in),
        vec(src.uv0), None, jnp.abs(jnp.asarray(_np(src.handed))) > 0.5,
        velocity, jscene, slot_map, mat_cols=vec(src.mat_cols))


@pytest.mark.parametrize("slot_map", SLOT_MAPS)
@pytest.mark.parametrize("source", SOURCES)
def test_gbuffer_tail_matches_reference(source, slot_map):
    args = chip_smoke.random_tail_call(source, slot_map, "cpu", seed=3)
    tri, z, src, pv, prev_pv, scene, _, stack_kernel = args
    got = G.gbuffer_tail(tri, z, src, {"proj_view": pv,
                                       "prev_proj_view": prev_pv},
                         scene, slot_map, stack_kernel=stack_kernel)
    ref = _reference(args)
    np.testing.assert_array_equal(_np(got.mask), _np(ref.mask))
    assert got.depth is z
    for field in G.GBUFFER_OUT:
        a, b = _np(getattr(got, field)), _np(getattr(ref, field))
        np.testing.assert_allclose(
            a, b, rtol=1e-5, atol=1e-4 if field == "normal" else 1e-5,
            err_msg=field)
    # uncovered pixels are zero, as _assemble clears them
    assert not _np(got.base_color)[_np(tri) < 0].any()


def test_cpu_tail_runs_the_plain_version(monkeypatch):
    """A CPU visibility plane never loads the library: gbuffer_tail is the
    PyTorch ops, equal to _gbuffer_tail_plain."""
    def boom():
        raise AssertionError("the CPU path loaded the CUDA library")

    monkeypatch.setattr(_build, "library", boom)
    args = chip_smoke.random_tail_call("planes", SLOT_MAPS[0], "cpu")
    tri, z, src, pv, prev_pv, scene, slot_map, _ = args
    got = G.gbuffer_tail(tri, z, src, {"proj_view": pv,
                                       "prev_proj_view": prev_pv},
                         scene, slot_map)
    want = G._gbuffer_tail_plain(*args)
    for field in G.GBUFFER_OUT + ("mask",):
        assert torch.equal(getattr(got, field), getattr(want, field))


def _args_of(source, slot_map=SLOT_MAPS[0], **kw):
    args = chip_smoke.random_tail_call(source, slot_map, "cpu")
    tri, _, src, pv, prev_pv, scene, slot_map, _ = args
    return args, G.tail_args(tri, src, pv, prev_pv, scene, slot_map, **kw)


def _channel_views(src):
    return (G._channels(src.world_pos, 3) + G._channels(src.n_in, 3)
            + G._channels(src.t_in, 3) + G._channels(src.bt_in, 3)
            + G._channels(src.uv0, 2) + [src.handed])


@pytest.mark.parametrize("source", ["planes", "torch", "megakernel", "band"])
def test_tail_args_reads_each_source_where_it_is(source):
    """Every channel is the caller's tensor read through its strides: the
    (C, H, W) planes' channels H * W apart, the (H, W, k) tensors' k apart,
    a band's rows at their offset; the megakernel's columns come from the
    material table by id."""
    (tri, z, src, pv, prev_pv, scene, slot_map, _), (a, keep) = \
        _args_of(source)
    h, w = tri.shape
    chans = _channel_views(src)
    n_mat = len(M.fast_used_cols(slot_map))
    if src.mat_cols is not None:
        chans += G._channels(src.mat_cols, n_mat)
    assert list(a.ch[:len(chans)]) == [t.data_ptr() for t in chans]
    assert list(a.st[:2 * len(chans)]) == [s for t in chans
                                          for s in t.stride()]
    assert not any(a.ch[len(chans):])
    if source in ("planes", "band"):  # channels a plane apart
        assert a.ch[1] - a.ch[0] == 4 * src.world_pos.stride(-1)
        assert tuple(a.st[:2]) == (w, 1)
    if source == "band":  # rows 2.. of the planes: a view at an offset
        assert src.world_pos.storage_offset() == 2 * w
    if source == "megakernel":
        assert a.mat_id == src.mat_plane.data_ptr() and not a.ht_abs
        assert list(a.mat_col[:n_mat]) == list(M.fast_used_cols(slot_map))
        assert a.materials == scene.materials.data_ptr()
        assert (a.mat_stride, a.n_materials) == (M.MATERIAL_STRIDE, 6)
    else:
        assert a.mat_id is None and a.ht_abs
    assert (a.tri, tuple(a.tri_st)) == (tri.data_ptr(), tri.stride())
    assert (a.h, a.w) == (h, w)
    assert (a.pv, a.prev_pv) == (pv.data_ptr(), prev_pv.data_ptr())
    for k, shape in (("base_color", (h, w, 3)), ("velocity", (h, w, 2)),
                     ("mask", (h, w))):
        assert tuple(keep[k].shape) == shape and keep[k].is_contiguous()
    assert list(a.out) == [keep[k].data_ptr() for k in G.GBUFFER_OUT]
    assert a.mask == keep["mask"].data_ptr() and keep["mask"].dtype == \
        torch.bool
    assert a.row_out is None and "row_out" not in keep


@pytest.mark.parametrize("slot_map", SLOT_MAPS)
def test_tail_args_slot_sources(slot_map):
    """A constant slot reads its colour columns, a sampled one its quad in
    the groups (stack position p is the p-th quad over the groups), and on
    the stacks path the stack_planes planes of its channels."""
    used = M.fast_used_cols(slot_map)
    (_, _, _, _, _, scene, _, _), (a, _) = _args_of("planes", slot_map)
    quads = [(g, 4 * q) for g, t in enumerate(
        G._stack_groups(scene, slot_map)) for q in range(t.shape[1] // 4)]
    for k, p in enumerate(slot_map):
        if p < 0:
            assert a.slot_kind[k] == G.SLOT_CONST
            assert used[a.col_const[k]] == M.MAT_CONST_BASE + 4 * k
        else:
            assert a.slot_kind[k] == G.SLOT_GATHER
            assert (a.slot_group[k], a.slot_word[k]) == quads[p]
    assert used[a.col_stack_base] == M.MAT_STACK_BASE
    assert used[a.col_stack_size] == M.MAT_STACK_SIZE
    assert used[a.col_base_factor] == M.MAT_BASE_COLOR_FACTOR
    assert used[a.col_emissive_factor] == M.MAT_EMISSIVE_FACTOR
    assert used[a.col_metallic] == M.MAT_METALLIC_FACTOR
    assert used[a.col_roughness] == M.MAT_ROUGHNESS_FACTOR
    n_groups = len(G._stack_groups(scene, slot_map)) \
        if any(p >= 0 for p in slot_map) else 0
    assert sum(bool(g) for g in a.groups) == n_groups

    args = chip_smoke.random_tail_call("stacks", slot_map, "cpu")
    sk = torch.zeros((12,) + tuple(args[0].shape))
    plane_of = {(k, c): 3 * k + c for k in range(5) for c in range(3)}
    a, _ = G.tail_args(args[0], *args[2:7], sk=sk, plane_of=plane_of)
    assert a.sk == sk.data_ptr() and not any(a.groups)
    for k, p in enumerate(slot_map):
        if p >= 0:
            assert a.slot_kind[k] == G.SLOT_PLANES
            assert list(a.slot_plane[3 * k:3 * k + 3]) == [3 * k + c
                                                          for c in range(3)]


def test_tail_args_debug_rows():
    (tri, *_), (a, keep) = _args_of("planes", debug=True)
    assert keep["row_out"].shape == tri.shape
    assert keep["row_out"].dtype == torch.int32
    assert a.row_out == keep["row_out"].data_ptr()


def test_tail_args_refuses_what_the_kernel_does_not_take():
    args = chip_smoke.random_tail_call("torch", SLOT_MAPS[1], "cpu")
    tri, z, src, pv, prev_pv, scene, slot_map, _ = args
    bad = G.TailInputs(src.world_pos, src.n_in, src.t_in, src.bt_in,
                       src.uv0, src.handed, mat_cols=src.mat_cols[..., :-1])
    with pytest.raises(ValueError, match="material columns"):
        G.tail_args(tri, bad, pv, prev_pv, scene, slot_map)
    bad = G.TailInputs(src.world_pos[:-1], src.n_in, src.t_in, src.bt_in,
                       src.uv0, src.handed, mat_cols=src.mat_cols)
    with pytest.raises(ValueError, match="input plane"):
        G.tail_args(tri, bad, pv, prev_pv, scene, slot_map)
    with pytest.raises(TypeError, match="int32"):
        G.tail_args(tri.long(), src, pv, prev_pv, scene, slot_map)
    # a group whose rows are not whole quads
    odd = types.SimpleNamespace(
        materials=scene.materials, texture_stack_a=scene.texture_stack_a[
            :, :6], texture_stack_b=scene.texture_stack_b,
        texture_stack_c=scene.texture_stack_c)
    with pytest.raises(ValueError, match="stack group"):
        G.tail_args(tri, src, pv, prev_pv, odd, slot_map)


def test_tail_args_refuses_offsets_past_32_bits():
    """The kernel's offsets are 32-bit: a plane whose elements lie more
    than 2^31 apart raises before any pointer is taken (meta tensors: no
    memory behind the strides)."""
    args = chip_smoke.random_tail_call("planes", SLOT_MAPS[1], "meta")
    tri, z, src, pv, prev_pv, scene, slot_map, _ = args
    h, w = tri.shape
    far = tuple(torch.empty(1, device="meta").as_strided((h, w), (2 ** 30, 1))
                for _ in range(3))
    bad = G.TailInputs(far, src.n_in, src.t_in, src.bt_in, src.uv0,
                       src.handed, mat_cols=src.mat_cols)
    with pytest.raises(ValueError, match="32-bit"):
        G.tail_args(tri, bad, pv, prev_pv, scene, slot_map)


_C_TYPES = {"const float*": ctypes.c_void_p, "float*": ctypes.c_void_p,
            "uint8_t*": ctypes.c_void_p, "const int*": ctypes.c_void_p,
            "int*": ctypes.c_void_p, "long long": ctypes.c_longlong,
            "int": ctypes.c_int, "float": ctypes.c_float}


def test_gbuffer_ctypes_layout_follows_the_c_struct():
    """GbufArgs has csrc/gbuffer.cu's fields in its order, with its types
    and array sizes (the card checks sizeof as well)."""
    with open(os.path.join(_build.CSRC, "gbuffer.cu")) as f:
        source = f.read()
    consts = {name: int(v) for name, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", source)}
    body = re.search(r"struct GbufArgs \{(.*?)\n\};", source, re.S).group(1)
    want = []
    for decl in re.sub(r"//[^\n]*", "", body).split(";"):
        decl = " ".join(decl.split())
        if not decl:
            continue
        ctype = max((t for t in _C_TYPES if decl.startswith(t + " ")),
                    key=len)
        for name in decl[len(ctype) + 1:].split(", "):
            dims = [eval(d, {}, consts) for d in re.findall(r"\[([^\]]+)\]",
                                                             name)]
            want.append((name.split("[")[0], _C_TYPES[ctype],
                         int(np.prod(dims)) if dims else 1))
    got = []
    for name, ctype in G.GbufArgs._fields_:
        n = 1
        if hasattr(ctype, "_length_"):
            ctype, n = ctype._type_, ctype._length_
        got.append((name, ctype, n))
    assert want == got
    assert (consts["kGeo"], consts["kMaxMat"]) == (G.N_GEO, G.MAX_MAT)
    # every used-column set fits: all five slots constant
    assert len(M.fast_used_cols((-1,) * 5)) == G.MAX_MAT


def test_build_flags_per_unit():
    """The two shading units, shading.cu and shading_ref.cu, alone build
    with multiply-add contraction (and division and roots to 2 ulps);
    every other unit with -fmad=false, and the build hands each unit its
    own flags."""
    units = [u for u in _build.sources() if u.endswith(".cu")]
    contract = {"shading.cu", "shading_ref.cu"}
    assert {os.path.basename(u) for u in units} >= contract | {"gbuffer.cu"}
    for u in units:
        flags = _build.unit_flags(u)
        fmad = [f for f in flags if f.startswith("-fmad=")]
        ours = os.path.basename(u) in contract
        assert fmad == ["-fmad=true" if ours else "-fmad=false"], (u, flags)
        assert ("-prec-div=false" in flags) == ours, (u, flags)
        assert ("-prec-sqrt=false" in flags) == ours, (u, flags)
        assert "arch=compute_90a,code=sm_90a" in flags


def test_build_runs_each_unit_with_its_flags(tmp_path, monkeypatch):
    """build() compiles each unit with unit_flags(unit) and links them;
    the library's name changes with the flag table."""
    cmds = []

    def run_all(batch):
        for cmd in batch:
            cmds.append(cmd)
            out = cmd[cmd.index("-o") + 1]
            open(out, "w").close()

    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build, "_run_all", run_all)
    so = _build.build()
    compiles = {c[-1]: c for c in cmds if "-c" in c}
    assert set(compiles) == {u for u in _build.sources() if u.endswith(".cu")}
    for unit, cmd in compiles.items():
        assert cmd[1:-4] == list(_build.unit_flags(unit)), cmd
    assert os.path.exists(so)
    monkeypatch.setattr(_build, "UNIT_FLAGS", {})
    assert _build._library_path() != so


def test_max_offset_is_the_farthest_element_of_a_view():
    """max_offset is the largest element offset from a view's first
    element, through its strides: what a 32-bit index must reach."""
    t = torch.zeros(5, 7, 3)
    assert _build.max_offset(t) == t.numel() - 1
    assert _build.max_offset(t[..., 1]) == 4 * 21 + 6 * 3
    assert _build.max_offset(t.permute(2, 0, 1)) == t.numel() - 1
    assert _build.max_offset(t[1:3, ::2]) == 21 + 3 * 6 + 2
    assert _build.max_offset(torch.zeros(0, 4)) <= 0
