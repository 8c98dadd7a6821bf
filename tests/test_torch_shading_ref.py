"""The reference sampling path's shading pass (``shading_pass``; on a card
the kernel K11, ``csrc/shading_ref.cu``) on the CPU: its plain version,
``_shading_ref_plain``, against the JAX package's ``shading_pass`` on
random G-buffers made with numpy, and the kernel's host side (the
argument block ``shade_ref_args`` packs, the ctypes layout against the C
struct, the dispatch).  The kernel itself runs only on a card
(tests/test_torch_cuda.py, chip_smoke.py phase 2).

The inputs aim at the pass's discontinuities: PCF taps within 1e-6 of the
compare (a plane at one light depth over a shadow map of that depth +-
1e-6, products exact in float32), normals and reflections on cube-face
diagonals (components of equal magnitude), roughness on the mip
boundaries (k / 7 and one ulp either side), sky pixels, a sun, a point
and a spot light.  One IBL of random maps for the module; no JAX frame.
Bar: rtol 2e-3 / atol 1e-4 per pixel.
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

from mo_renderer_tpu.device import sampling as JSm  # noqa: E402
from mo_renderer_tpu.passes import shading as JSh  # noqa: E402
from mo_renderer_tpu_torch.device import sampling as S  # noqa: E402
from mo_renderer_tpu_torch.kernels import _build  # noqa: E402
from mo_renderer_tpu_torch.passes import shading as Sh  # noqa: E402
from mo_renderer_tpu_torch.passes.gbuffer import GBuffer  # noqa: E402

H, W = 24, 32
SHADOW = 16
SOURCE = os.path.join(_build.CSRC, "shading_ref.cu")
COMMON = os.path.join(_build.CSRC, "shading_common.cuh")


@pytest.fixture(scope="module")
def maps():
    """Random IBL maps as numpy: the irradiance and environment cubes, a
    3-level specular chain and the BRDF LUT."""
    rng = np.random.default_rng(7)

    def cube(s, hi=2.0):
        return rng.uniform(0.0, hi, (6, s, s, 3)).astype(np.float32)

    return {"irradiance": cube(4), "environment": cube(8, 4.0),
            "mips": [cube(8), cube(4), cube(2)],
            "lut": rng.uniform(0.0, 1.0, (8, 8, 3)).astype(np.float32)}


def _ibl(maps, side):
    """The maps as the JAX package's or the port's IBL object."""
    if side == "jax":
        return types.SimpleNamespace(
            irradiance_faces=jnp.asarray(maps["irradiance"]),
            environment_faces=jnp.asarray(maps["environment"]),
            specular_mips=JSm.MipCube([jnp.asarray(m) for m in maps["mips"]]),
            brdf_lut=jnp.asarray(maps["lut"]))
    # the four maps of IBLMaps the reference path reads
    return types.SimpleNamespace(
        environment_faces=torch.from_numpy(maps["environment"]),
        irradiance_faces=torch.from_numpy(maps["irradiance"]),
        specular_mips=S.MipCube.from_mips(
            [torch.from_numpy(m) for m in maps["mips"]]),
        brdf_lut=torch.from_numpy(maps["lut"]))


def _lights(n=3):
    """GpuLight rows: a sun, a point light and a spot light."""
    rows = np.zeros((n, 20), np.float32)
    rows[0, [0, 12, 13, 14, 16]] = [0.0, -0.3, -1.0, -0.2, 3.0]
    rows[0, 8:11] = [1.0, 0.9, 0.8]
    rows[1, 0], rows[1, 4:7], rows[1, 8:11] = 1.0, [1.0, 2.0, -1.0], [4, 2, 1]
    rows[1, 16:19] = [1.0, 0.09, 0.032]
    rows[2, 0], rows[2, 2] = 2.0, 8.0
    rows[2, 4:7], rows[2, 8:11] = [0.0, 3.0, 0.5], [2.0, 3.0, 4.0]
    rows[2, 12:15], rows[2, 16:19] = [0.0, -1.0, -0.2], [1.0, 0.05, 0.01]
    return rows[:n]


def _case(seed=0, ties=False):
    """(G-buffer planes, ssao, shadow map, light_pv, camera block) as
    numpy.  ``ties``: every pixel on the light-space plane z = 0.5 under an
    orthographic light_pv whose products are exact, over a shadow map of
    that plane's biased depth +- 1e-6, so that every PCF tap compares
    within 1e-6."""
    rng = np.random.default_rng(seed)
    q = np.float32(1 / 64)
    pos = (rng.integers(-128, 128, (H, W, 3)) * q).astype(np.float32)
    normal = rng.normal(size=(H, W, 3)).astype(np.float32)
    # cube-face diagonals: equal magnitudes in two or three components
    normal[0, :8] = [[1, 1, 0], [-1, 1, 0], [1, -1, 1], [0, -1, -1],
                     [0.5, 0.5, 0.5], [-2, 1, 2], [1, 0, -1], [0, 0, 0]]
    normal = normal / np.maximum(np.linalg.norm(normal, axis=-1,
                                                keepdims=True), 1e-6)
    orm = rng.uniform(0.0, 1.0, (H, W, 3)).astype(np.float32)
    # roughness on the mip boundaries: k / 7 and one ulp either side
    edges = np.float32(np.arange(8) / 7.0)
    orm[1, :8, 1] = edges
    orm[2, :8, 1] = np.nextafter(edges, np.float32(2))
    orm[3, :8, 1] = np.nextafter(edges, np.float32(-1))
    depth = rng.uniform(0.2, 1.0, (H, W)).astype(np.float32)
    depth[rng.uniform(size=(H, W)) < 0.25] = 1.0  # sky
    light_pv = np.array([[0.25, 0, 0, 0], [0, 0.25, 0, 0],
                         [0.0625, 0.03125, 0.125, 0.5], [0, 0, 0, 1]],
                        np.float32)
    smap = rng.uniform(0.3, 0.9, (SHADOW, SHADOW)).astype(np.float32)
    if ties:
        light_pv[2] = [0, 0, 0.25, 0.5]
        pos[..., 2] = 0.0
        current = np.float32(np.float32(0.5) - np.float32(Sh.SHADOW_BIAS))
        smap = (current + rng.uniform(-1e-6, 1e-6, smap.shape)).astype(
            np.float32)
    planes = {
        "position": pos, "normal": normal.astype(np.float32), "orm": orm,
        "base_color": rng.uniform(0, 1, (H, W, 3)).astype(np.float32),
        "emissive": rng.uniform(0, 0.1, (H, W, 3)).astype(np.float32),
        "depth": depth}
    camera = {"eye_pos": np.array([0.5, 1.5, -3.0], np.float32),
              "right": np.array([1, 0, 0], np.float32),
              "up": np.array([0, 0.8, 0.6], np.float32),
              "direction": np.array([0, -0.6, 0.8], np.float32),
              "near": np.array(0.1, np.float32),
              "near_wh": np.array([0.16, 0.09], np.float32)}
    ssao = rng.uniform(0.3, 1.0, (H, W)).astype(np.float32)
    return planes, ssao, smap, light_pv, camera


def _run(side, case, lights, ibl, shadow=True):
    planes, ssao, smap, light_pv, camera = case
    conv = jnp.asarray if side == "jax" else torch.from_numpy
    params = {k: conv(v) for k, v in camera.items()}
    params["light_proj_view"] = conv(light_pv)
    gbuf = types.SimpleNamespace(**{k: conv(v) for k, v in planes.items()})
    smap = conv(smap) if shadow else None
    if side == "jax":
        return np.asarray(JSh.shading_pass(gbuf, conv(ssao), smap,
                                           conv(lights), len(lights), params,
                                           ibl=ibl))
    return Sh._shading_ref_plain(gbuf, conv(ssao), smap, conv(lights),
                                 len(lights), params, ibl).numpy()


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("with_ibl,shadow", [
    (True, True), (False, True), (True, False), (False, False)])
def test_plain_matches_jax(maps, ties, with_ibl, shadow):
    """_shading_ref_plain against the JAX shading_pass on the same numpy
    inputs, at rtol 2e-3 / atol 1e-4 per pixel, with and without IBL and a
    shadow map, three lights of the three kinds."""
    case = _case(seed=1, ties=ties)
    want = _run("jax", case, _lights(), _ibl(maps, "jax") if with_ibl
                else None, shadow)
    got = _run("torch", case, _lights(), _ibl(maps, "torch") if with_ibl
               else None, shadow)
    assert got.shape == (H, W, 3)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-4)


def test_tie_case_puts_taps_on_the_compare(maps):
    """The tie case does what it claims: its shadow factors take several
    values, so that taps fall on both sides of the compare within 1e-6."""
    planes, _, smap, light_pv, _ = _case(seed=1, ties=True)
    f = Sh.calculate_shadow(torch.from_numpy(planes["position"]),
                            torch.from_numpy(light_pv),
                            torch.from_numpy(smap))
    assert len(torch.unique(f)) >= 4


def _gbuf(case, device="cpu"):
    planes = {k: torch.from_numpy(v).to(device) for k, v in case[0].items()}
    return GBuffer(velocity=torch.zeros(H, W, 2, device=device),
                   mask=planes["depth"] < 1.0, **planes)


def _args(maps, case, shadow=True, ibl=True):
    planes, ssao, smap, light_pv, camera = case
    params = {k: torch.from_numpy(v) for k, v in camera.items()}
    params["light_proj_view"] = torch.from_numpy(light_pv)
    return (_gbuf(case), torch.from_numpy(ssao),
            torch.from_numpy(smap) if shadow else None,
            torch.from_numpy(_lights()), 3, params,
            _ibl(maps, "torch") if ibl else None)


_C_TYPES = {"const float*": ctypes.c_void_p, "float*": ctypes.c_void_p,
            "int*": ctypes.c_void_p, "float": ctypes.c_float,
            "int": ctypes.c_int}


def test_ctypes_layout_follows_the_c_struct():
    """ShadeRefArgs has csrc/shading_ref.cu's fields in its order, with its
    types and array sizes (the card checks sizeof as well)."""
    with open(COMMON) as f:
        consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", f.read()))
    with open(SOURCE) as f:
        body = re.search(r"struct ShadeRefArgs \{(.*?)\n\};", f.read(), re.S)
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
            want.append((name.split("[")[0].rstrip("_"), _C_TYPES[ctype],
                         int(np.prod(dims)) if dims else 1))
    got = []
    for name, ctype in Sh.ShadeRefArgs._fields_:
        n = getattr(ctype, "_length_", None)  # an array field
        got.append((name, ctype._type_ if n else ctype, n or 1))
    assert want == got


def test_args_read_planes_where_they_are(maps):
    """Strided views go in as they are (their pointers and strides), the
    tap offsets are the plain version's float32(dx / S), the level tables
    and map sizes are the chain's, the light count is clamped to the
    table."""
    case = _case()
    gbuf, ssao, smap, lights, _, params, ibl = _args(maps, case)
    big = torch.zeros(W, H, 4)
    big[..., :3] = gbuf.normal.transpose(0, 1)
    gbuf.normal = big.transpose(0, 1)[..., :3]  # a view: (4, 4H, 1)
    a, keep = Sh.shade_ref_args(gbuf, ssao[:, :], smap, lights, 99, params,
                                ibl, debug=True)
    assert a.planes[1] == gbuf.normal.data_ptr()
    assert list(a.strides[3:6]) == [4, 4 * H, 1]
    assert (a.h, a.w, a.n_lights, a.shadow_size) == (H, W, 3, SHADOW)
    want = [np.float32(d * (1.0 / SHADOW)) for p in Sh.POISSON for d in p]
    assert list(np.float32(a.tap_off)) == want
    mips = ibl.specular_mips
    assert list(a.sizes[:3]) == list(mips.sizes)
    assert list(a.offsets[:3]) == list(mips.offsets)
    assert (a.irr_size, a.env_size, a.num_levels, a.lut_h, a.lut_c) == \
        (4, 8, 3, 8, 3)
    assert keep["out"].shape == (H, W, 3)
    assert keep["dbg"].shape == (H, W, len(Sh.REF_DEBUG)) == (H, W, 17)
    b, _ = Sh.shade_ref_args(*_args(maps, case, shadow=False, ibl=False))
    assert (b.shadow, b.has_ibl, b.irr, b.dbg) == (None, 0, None, None)


def test_cuda_wrapper_refuses_what_the_kernel_does_not_take(maps):
    """A float64 plane, an SSAO plane on another device and a non-square
    shadow map raise before any launch; a light table past one chunk of
    the shared memory (539 rows) or two (1025) builds its arguments, with
    the chunk's rows, the light columns and the levels the kernel's
    own."""
    case = _case()
    args = list(_args(maps, case))
    bad = list(args)
    bad[0] = _gbuf(case)
    bad[0].orm = bad[0].orm.double()
    with pytest.raises(ValueError, match="float32"):
        Sh._shading_ref_cuda(*bad)
    bad = list(args)
    bad[1] = torch.empty(H, W, device="meta")
    with pytest.raises(ValueError, match="meta"):
        Sh._shading_ref_cuda(*bad)
    bad = list(args)
    bad[2] = torch.zeros(SHADOW, SHADOW + 1)
    with pytest.raises(ValueError, match="shadow map"):
        Sh.shade_ref_args(*bad)
    consts = {}
    for path in (COMMON, SOURCE):
        with open(path) as f:
            for name, v in re.findall(r"constexpr int (k\w+) = ([^;]+);",
                                      f.read()):
                consts[name] = eval(v.replace("/", "//"), {}, dict(consts))
    assert (consts["kLightCols"], consts["kLightChunkRows"],
            consts["kMaxLevels"]) == (Sh.LIGHT_COLS, Sh.LIGHT_CHUNK_ROWS,
                                      Sh.MAX_LEVELS)
    for n in (Sh.LIGHT_CHUNK_ROWS + 1, 1025):
        lights = torch.zeros(n, 20)
        a, keep = Sh.shade_ref_args(*args[:3], lights, n, *args[5:])
        assert (a.n_lights, a.light_stride) == (n, 20)
        assert a.lights == lights.data_ptr() == keep["lights"].data_ptr()


def test_args_refuse_offsets_past_32_bits(maps):
    """The kernel's offsets are 32-bit: a plane whose elements lie more
    than 2^31 apart raises before any pointer is taken (a meta tensor: no
    memory behind the strides)."""
    args = list(_args(maps, _case()))
    gbuf = args[0]
    gbuf.emissive = torch.empty(1, device="meta").as_strided(
        (H, W, 3), (2 ** 27, 3, 1))
    with pytest.raises(ValueError, match="32-bit"):
        Sh.shade_ref_args(*args)


def test_cpu_gbuffer_runs_the_plain_version(maps, monkeypatch):
    """A CPU G-buffer never touches the library: shading_pass is the
    plain version's result."""
    def launch(*a):
        raise AssertionError("the CPU launched the kernel")

    monkeypatch.setattr(Sh, "launch_shading_ref", launch)
    monkeypatch.setattr(_build, "library", launch)
    args = _args(maps, _case())
    got = Sh.shading_pass(*args[:6], ibl=args[6])
    assert torch.equal(got, Sh._shading_ref_plain(*args))
