"""The reference sampling path's G-buffer pass (``gbuffer_pass``; on a card
the kernel K12, ``csrc/gbuffer_ref.cu``) on the CPU: its plain version,
``_gbuffer_ref_plain``, against the JAX package's ``gbuffer_pass`` on
random inputs made with numpy (``chip_smoke.random_ref_inputs``), and the
kernel's host side (the argument block ``gbuffer_ref_args`` packs, the
ctypes layout against the C struct, the kernel's constants, the
dispatch), chip_smoke.py's odd-edge cut of a call (``edge_cut``) and its
SASS report of each template instance.  The kernel itself runs only on
a card (tests/test_torch_cuda.py, chip_smoke.py phase 2).

The inputs aim at the pass's discontinuities: UVs on texel centres and
one ulp either side, negative UVs and UVs past 1 (REPEAT), each slot on
UV set 0 or 1 (material values 0.0, -0.0, 1.0, -1.0), has_tangent both
ways, |qs| at the 1e-20 guard and one ulp either side, uncovered pixels.
24 x 32 pixels, a 4-layer 8 x 8 texture array; no JAX frame.
Bar: rtol 2e-3 / atol 1e-4 per plane, the mask equal.
"""

import ctypes
import os
import re
import shutil
import subprocess
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
from mo_renderer_tpu_torch.passes import gbuffer as GB  # noqa: E402

H, W = 24, 32
SOURCE = os.path.join(_build.CSRC, "gbuffer_ref.cu")
CASES = {"mixed": {}, "uv0": {"slot_uv": 0.0}, "uv1": {"slot_uv": 1.0},
         "tangents": {"tangent": True}, "no tangents": {"tangent": False}}


def _jax(inputs):
    def j(a):
        return jnp.asarray(a)

    return JG.gbuffer_pass(
        j(inputs["tri"]), j(inputs["z"]), j(inputs["b0"]), j(inputs["b1"]),
        types.SimpleNamespace(**{k: j(v) for k, v in
                                 inputs["scene"].items()}),
        types.SimpleNamespace(**{k: j(v) for k, v in inputs["vs"].items()}))


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_jax(case):
    """_gbuffer_ref_plain against the JAX gbuffer_pass on the same numpy
    inputs: each plane at rtol 2e-3 / atol 1e-4, the mask equal, the depth
    passed through."""
    inputs = chip_smoke.random_ref_inputs(seed=len(case), **CASES[case])
    want = _jax(inputs)
    args = chip_smoke.ref_call(inputs, "cpu")
    got = GB._gbuffer_ref_plain(*args)
    assert got.depth is args[1]
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    for name in GB.GBUFFER_OUT:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape == (H, W, 2 if name == "velocity" else 3)
        np.testing.assert_allclose(g, w, rtol=2e-3, atol=1e-4, err_msg=name)


def test_inputs_reach_the_discontinuities():
    """The mixed case does what it claims, at the covered pixels: texel
    anchors that differ across one ulp of a texel centre, UVs below 0 and
    past 1, both UV sets on some slot, has_tangent both ways, the guard
    taken and not taken; and uncovered pixels."""
    inputs = chip_smoke.random_ref_inputs(seed=0)
    args = chip_smoke.ref_call(inputs, "cpu")
    tri = args[0]
    covered = tri >= 0
    assert 0 < int(covered.sum()) < H * W
    # pixels (0, 3..8): corner 0 exactly, a texel centre, +1 and -1 ulp
    uv0 = inputs["scene"]["uv0"]
    x = uv0[3:9, 0] * np.float32(8) - np.float32(0.5)
    assert (x[0:2] == np.floor(x[0:2])).all()
    assert (np.floor(x[2:4]) == x[0:2]).all()
    assert (np.floor(x[4:6]) == x[0:2] - 1).all()
    anchors, _ = chip_smoke.gbuffer_ref_choices(args)
    row = anchors[0, 3:9, 0]
    assert (row[0:2] == row[2:4]).all() and (row[0:2] != row[4:6]).all()
    vs, scene = args[5], args[4]
    idx = scene.indices.long()[tri.clamp(min=0).long()][covered]
    uv = scene.uv0[idx]
    assert (uv < 0).any() and (uv > 1).any()
    bits = anchors[..., -1][covered]
    for k in range(5):
        on = (bits >> k) & 1
        if on.min() == 0 and on.max() == 1:
            break
    else:
        raise AssertionError("no slot samples both UV sets")
    ht = vs.has_tangent[idx[:, 0]]
    assert ht.any() and not ht.all()
    qs = vs.inv_w[:3]  # pixels (0, 0..2): qs = 1/w of corner 0
    assert [bool(abs(q) > np.float32(1e-20)) for q in qs] == [
        False, True, False]
    assert (tri[0, :9] == torch.arange(9, dtype=torch.int32)).all()


_C_TYPES = {"const int*": ctypes.c_void_p, "const float*": ctypes.c_void_p,
            "const uint8_t*": ctypes.c_void_p,
            "const unsigned*": ctypes.c_void_p, "float*": ctypes.c_void_p,
            "uint8_t*": ctypes.c_void_p, "int*": ctypes.c_void_p,
            "float": ctypes.c_float, "int": ctypes.c_int}


def test_ctypes_layout_follows_the_c_struct():
    """GbufRefArgs has csrc/gbuffer_ref.cu's fields in its order, with its
    types and array sizes (the card checks sizeof as well)."""
    with open(SOURCE) as f:
        src = f.read()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    body = re.search(r"struct GbufRefArgs \{(.*?)\n\};", src, re.S)
    want = []
    for decl in re.sub(r"//[^\n]*", "", body.group(1)).split(";"):
        decl = " ".join(decl.split())
        if not decl:
            continue
        ctype = max((t for t in _C_TYPES if decl.startswith(t + " ")),
                    key=len)
        for name in decl[len(ctype) + 1:].split(", "):
            dims = [int(consts.get(d, d))
                    for d in re.findall(r"\[(\w+)\]", name)]
            want.append((name.split("[")[0], _C_TYPES[ctype],
                         int(np.prod(dims)) if dims else 1))
    got = []
    for name, ctype in GB.GbufRefArgs._fields_:
        n = getattr(ctype, "_length_", None)  # an array field
        got.append((name, ctype._type_ if n else ctype, n or 1))
    assert want == got


def test_kernel_constants_follow_the_python_side():
    """The material columns, attribute slots and debug channels the kernel
    names are assets/materials.py's and passes/gbuffer.py's."""
    with open(SOURCE) as f:
        consts = {k: int(v) for k, v in
                  re.findall(r"constexpr int (k\w+) = (\d+);", f.read())}
    assert (consts["kMatMap"], consts["kMatUv"], consts["kMatBaseFactor"],
            consts["kMatEmissiveFactor"], consts["kMatMetallic"],
            consts["kMatRoughness"]) == (
        M.MAT_BASE_COLOR_MAP, M.MAT_BASE_COLOR_UV, M.MAT_BASE_COLOR_FACTOR,
        M.MAT_EMISSIVE_FACTOR, M.MAT_METALLIC_FACTOR,
        M.MAT_ROUGHNESS_FACTOR)
    assert [M.MAT_BASE_COLOR_MAP + k for k in range(5)] == [
        M.MAT_BASE_COLOR_MAP, M.MAT_NORMAL_MAP, M.MAT_MR_MAP,
        M.MAT_OCCLUSION_MAP, M.MAT_EMISSIVE_MAP]
    assert consts["kMatRoughness"] + 1 == GB.REF_MAT_COLS
    assert consts["kMatCols"] == GB.REF_MAT_COLS  # read as 4-float vectors
    assert GB.REF_MAT_COLS % 4 == 0
    names = ["WorldPos", "Normal", "Tangent", "Bitangent", "Clip",
             "PrevClip", "Uv0", "Uv1"]
    assert [consts[f"kAttr{n}"] for n in names] == list(range(8))
    assert consts["kAttrs"] == len(GB.REF_ATTRS)
    assert consts["kDbgChannels"] == len(GB.REF_DEBUG)
    assert consts["kDbgUvSets"] == GB.REF_DEBUG.index("uv_sets")


def test_args_read_inputs_where_they_are():
    """Strided views go in as they are (their pointers and strides), the
    tables' extents and the texture size are the scene's, the debug output
    is (H, W, 6)."""
    tri, z, b0, b1, scene, vs = chip_smoke.ref_call(
        chip_smoke.random_ref_inputs(), "cpu")
    b0 = b0.t().contiguous().t()  # column-major: strides (1, H)
    wide = torch.zeros(scene.uv1.shape[0], 5)
    wide[:, 1:3] = scene.uv1
    scene.uv1 = wide[:, 1:3]
    a, keep = GB.gbuffer_ref_args(tri, b0, b1, scene, vs, debug=True)
    assert a.b0 == b0.data_ptr() and list(a.b0_st) == [1, H]
    assert a.attr[7] == scene.uv1.data_ptr()
    assert list(a.attr_st[14:16]) == [5, 1]
    assert a.attr[4] == vs.clip.data_ptr() and list(a.attr_st[8:10]) == [4, 1]
    assert (a.n_tris, a.n_verts, a.n_meshes, a.n_materials) == (16, 40, 5, 4)
    assert (a.n_texels, a.tex_size, a.h, a.w) == (4 * 64, 8, H, W)
    assert a.inv255 == np.float32(1.0 / 255.0)
    assert keep["dbg"].shape == (H, W, len(GB.REF_DEBUG)) == (H, W, 6)
    assert keep["velocity"].shape == (H, W, 2)
    assert all(keep[k].is_contiguous() for k in GB.GBUFFER_OUT)
    b, keep = GB.gbuffer_ref_args(tri, b0, b1, scene, vs)
    assert b.dbg is None and "dbg" not in keep


def test_args_refuse_what_the_kernel_does_not_take():
    """A float64 barycentric plane, int64 indices, a texture array that is
    not contiguous or not RGBA8, a vertex table of another length, a plane
    on another device: each raises before any pointer is taken."""
    args = chip_smoke.ref_call(chip_smoke.random_ref_inputs(), "cpu")
    tri, z, b0, b1, scene, vs = args
    with pytest.raises(ValueError, match="b0"):
        GB.gbuffer_ref_args(tri, b0.double(), b1, scene, vs)
    with pytest.raises(ValueError, match="meta"):
        GB.gbuffer_ref_args(tri, b0, torch.empty(H, W, device="meta"),
                            scene, vs)

    def swapped(ns, **kw):
        return types.SimpleNamespace(**{**vars(ns), **kw})

    for what, bad in (
            ("indices", swapped(scene, indices=scene.indices.long())),
            ("textures", swapped(scene,
                                 textures=scene.textures.transpose(1, 2))),
            ("textures", swapped(scene,
                                 textures=scene.textures[..., :3])),
            ("materials", swapped(scene,
                                  materials=scene.materials[:, :12]))):
        with pytest.raises(ValueError, match=what):
            GB.gbuffer_ref_args(tri, b0, b1, bad, vs)
    with pytest.raises(ValueError, match="world_normal"):
        GB.gbuffer_ref_args(tri, b0, b1, scene,
                            swapped(vs, world_normal=vs.world_normal[:-1]))


def test_args_refuse_offsets_past_32_bits():
    """The kernel's offsets are 32-bit: an input whose elements lie more
    than 2^31 apart raises before any pointer is taken (a meta tensor: no
    memory behind the strides)."""
    tri, z, b0, b1, scene, vs = chip_smoke.ref_call(
        chip_smoke.random_ref_inputs(), "meta")
    vs.world_pos = torch.empty(1, device="meta").as_strided(
        (40, 3), (2 ** 26, 1))
    with pytest.raises(ValueError, match="32-bit"):
        GB.gbuffer_ref_args(tri, b0, b1, scene, vs)


def test_cpu_planes_run_the_plain_version(monkeypatch):
    """A CPU visibility buffer never touches the library: gbuffer_pass is
    the plain version's result."""
    def launch(*a):
        raise AssertionError("the CPU launched the kernel")

    monkeypatch.setattr(GB, "launch_gbuffer_ref", launch)
    monkeypatch.setattr(_build, "library", launch)
    args = chip_smoke.ref_call(chip_smoke.random_ref_inputs(), "cpu")
    got = GB.gbuffer_pass(*args)
    want = GB._gbuffer_ref_plain(*args)
    for name in (*GB.GBUFFER_OUT, "mask", "depth"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


def test_choices_follow_the_plain_sampler():
    """gbuffer_ref_choices, what the card's debug output is held to, reads
    the plain version's own sampler calls: its anchors are the flat
    indices of the taps' first texel, -1 where uncovered."""
    args = chip_smoke.ref_call(chip_smoke.random_ref_inputs(seed=3), "cpu")
    tri, _, _, _, scene, _ = args
    out, rows = chip_smoke.gbuffer_ref_choices(args)
    assert out.shape == (H, W, len(GB.REF_DEBUG))
    assert len(rows) == 20
    covered = tri >= 0
    assert (out[~covered] == -1).all() and (out[covered] >= 0).all()
    for k in range(5):
        assert torch.equal(out[..., k][covered], rows[4 * k])
    n_texels = scene.textures.reshape(-1, 4).shape[0]
    taps = torch.cat(rows)
    assert 0 <= int(taps.min()) and int(taps.max()) < n_texels


def test_edge_cut_is_odd_and_strided():
    """chip_smoke.edge_cut, the odd-edge call of chip_smoke phase 2: H and
    W odd and neither a multiple of the kernel's tile or of a 4-float
    vector; the planes are views of the call's (its row strides), the
    tables the call's own; the plain version on the cut is the cut of the
    plain version on the whole (the mask exactly; the planes within an
    ulp or so, as the CPU's vector loops round a tail apart)."""
    with open(SOURCE) as f:
        consts = {k: int(v) for k, v in
                  re.findall(r"constexpr int (k\w+) = (\d+);", f.read())}
    args = chip_smoke.ref_call(chip_smoke.random_ref_inputs(h=40, w=70),
                               "cpu")
    cut = chip_smoke.edge_cut(args)
    h, w = cut[0].shape
    assert (h, w) == (31, 67) and h % 2 == w % 2 == 1
    assert h % consts["kTileH"] and w % 32 and w % 4
    for a, b in zip(cut[:4], args[:4]):
        assert a.data_ptr() == b.data_ptr() and a.stride() == (70, 1)
    assert cut[4] is args[4] and cut[5] is args[5]
    whole, part = GB._gbuffer_ref_plain(*args), GB._gbuffer_ref_plain(*cut)
    assert torch.equal(part.mask, whole.mask[:h, :w])
    for name in GB.GBUFFER_OUT:
        np.testing.assert_allclose(getattr(part, name).numpy(),
                                   getattr(whole, name)[:h, :w].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=name)


def test_sass_report_splits_template_instances(monkeypatch):
    """chip_smoke.sass_report adds a template's instances up under its
    name, or keeps each apart with its mangled arguments (K12's dense and
    strided instances), from cuobjdump's resource and SASS listings."""
    res = ("Function _ZN12_GLOBAL__N_118gbuffer_ref_kernelILb1EEEv11GbufRef"
           "Args:\n REG:56 STACK:0 SHARED:8704\n"
           "Function _ZN12_GLOBAL__N_118gbuffer_ref_kernelILb0EEEv11GbufRef"
           "Args:\n REG:64 STACK:8 SHARED:8704\n")
    sass = ("\t\tFunction : _ZN12_GLOBAL__N_118gbuffer_ref_kernelILb1EEEv11"
            "GbufRefArgs\n"
            "        /*0000*/                   LDG.E R2, desc[UR4][R2.64] ;\n"
            "        /*0010*/                   FMUL R3, R2, R2 ;\n"
            "\t\tFunction : _ZN12_GLOBAL__N_118gbuffer_ref_kernelILb0EEEv11"
            "GbufRefArgs\n"
            "        /*0000*/                   STS [R0], R1 ;\n")

    def run(cmd, **kw):
        return types.SimpleNamespace(stdout=res if cmd[1] == "-res-usage"
                                     else sass)

    monkeypatch.setattr(shutil, "which", lambda _: "cuobjdump")
    monkeypatch.setattr(subprocess, "run", run)
    both = chip_smoke.sass_report("lib.so")["gbuffer_ref_kernel"]
    assert (both["registers"], both["stack"], both["instructions"],
            both["ldg"], both["fp32"], both["sts"]) == (64, 8, 3, 1, 1, 1)
    apart = chip_smoke.sass_report("lib.so", instances=True)
    assert set(apart) == {"gbuffer_ref_kernel<Lb1>", "gbuffer_ref_kernel<Lb0>"}
    dense = apart["gbuffer_ref_kernel<Lb1>"]
    assert (dense["registers"], dense["instructions"], dense["ldg"]) == (
        56, 2, 1)
    assert apart["gbuffer_ref_kernel<Lb0>"]["sts"] == 1
