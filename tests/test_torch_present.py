"""The port's checkerboard decimation, reconstruction + interleave (the
plain version of csrc/interleave.cu, both entries) and present pass
against the JAX reference: all exact.  The JAX interleave runs its Pallas kernel
(interleave_cols_pallas) in interpret mode."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from mo_renderer_tpu.kernels import decimate as JD  # noqa: E402
from mo_renderer_tpu.passes import checkerboard as JCB  # noqa: E402
from mo_renderer_tpu.passes import present as JP  # noqa: E402
from mo_renderer_tpu_torch.kernels import decimate as D  # noqa: E402
from mo_renderer_tpu_torch.passes import checkerboard as CB  # noqa: E402
from mo_renderer_tpu_torch.passes import present as P  # noqa: E402


def _u32_to_i32(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.mark.parametrize("phase", [0, 1, "cb", "anti"])
def test_decimate_cols_matches_reference(phase):
    rng = np.random.default_rng(0)
    x = rng.integers(-5, 1 << 20, (16, 256)).astype(np.int32)
    want = np.asarray(JD.decimate_cols(jnp.asarray(x), phase))
    got = D.decimate_cols(torch.from_numpy(x), phase).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(8, 128), (16, 960)])
def test_interleave_matches_reference_kernel(shape):
    rng = np.random.default_rng(2)
    a = rng.integers(0, 1 << 31, shape).astype(np.int32)
    b = rng.integers(0, 1 << 31, shape).astype(np.int32)
    want = np.asarray(JD.interleave_cols_pallas(
        jnp.asarray(a), jnp.asarray(b), interpret=True
    ))
    got = D.interleave_cols(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("h,wc,n_ids", [(16, 64, 3), (32, 128, 40), (9, 33, 2)])
def test_reconstruct_full_matches_reference(h, wc, n_ids):
    """Exact: the fill averages 8-bit values with 0/1 weights."""
    rng = np.random.default_rng(h * wc)
    cb = rng.integers(0, 1 << 32, (h, wc), dtype=np.uint64).astype(np.uint32)
    cb |= np.uint32(0xFF000000)
    # blocky ids (surfaces) with -1 sky, so both the matched and the
    # fallback average occur
    ids = rng.integers(-1, n_ids, (h // 4 + 1, wc // 8 + 1)).astype(np.int32)
    tri = np.repeat(np.repeat(ids, 4, 0), 16, 1)[:h, : 2 * wc]
    tri = np.where(rng.random((h, 2 * wc)) < 0.05, n_ids + 7, tri)
    want = np.asarray(JCB.reconstruct_full(jnp.asarray(cb), jnp.asarray(tri)))
    got = CB.reconstruct_full(_u32_to_i32(cb), torch.from_numpy(tri))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("h,wc,n_ids", [(16, 64, 3), (32, 128, 40), (9, 33, 2)])
def test_reconstruct_present_matches_reference(h, wc, n_ids):
    """The fused entry (float colour in, quantised as the present pass
    does) against the reference's present pass followed by its
    reconstruction: exact."""
    rng = np.random.default_rng(h * wc + 1)
    color = rng.uniform(-0.2, 1.2, (h, wc, 3)).astype(np.float32)
    halves = ((rng.integers(0, 255, (h, wc, 3)) + 0.5) / 255).astype(
        np.float32)
    color = np.where(rng.random((h, wc, 3)) < 0.2, halves, color)
    ids = rng.integers(-1, n_ids, (h // 4 + 1, wc // 8 + 1)).astype(np.int32)
    tri = np.repeat(np.repeat(ids, 4, 0), 16, 1)[:h, : 2 * wc]
    tri = np.where(rng.random((h, 2 * wc)) < 0.05, n_ids + 7, tri)
    want = np.asarray(JCB.reconstruct_full(
        JP.present_pass(jnp.asarray(color)), jnp.asarray(tri)))
    got = CB.reconstruct_present(torch.from_numpy(color),
                                 torch.from_numpy(tri))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    packed = CB.reconstruct_full(P.present_pass(torch.from_numpy(color)),
                                 torch.from_numpy(tri))
    assert torch.equal(got, packed)


def test_present_pass_matches_reference():
    rng = np.random.default_rng(5)
    color = rng.uniform(-0.2, 1.2, (24, 40, 3)).astype(np.float32)
    color[0, :6, 0] = [0.5 / 255, 1.5 / 255, 2.5 / 255, 0.0, 1.0, 254.5 / 255]
    want = np.asarray(JP.present_pass(jnp.asarray(color)))
    got = P.present_pass(torch.from_numpy(color))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(P.unpack_rgba8(got), JP.unpack_rgba8(want))


def test_cpu_tensor_reconstruct_never_touches_the_kernel(monkeypatch):
    from mo_renderer_tpu_torch.kernels import _build

    def boom(*a, **k):
        raise AssertionError("kernel library touched for a CPU tensor")

    monkeypatch.setattr(_build, "library", boom)
    cb = torch.full((4, 8), -16777216, dtype=torch.int32)
    tri = torch.zeros((4, 16), dtype=torch.int32)
    out = CB.reconstruct_full(cb, tri)
    assert out.shape == (4, 16)
    fused = CB.reconstruct_present(torch.ones((4, 8, 3)), tri)
    assert torch.equal(fused, torch.full((4, 16), -1, dtype=torch.int32))
