"""IBLResource — environment lighting precompute on a torch device (port
of ``mo_renderer_tpu/assets/ibl_resource.py``).

Equirect -> cubemap, irradiance convolution, GGX specular prefilter mips
and the BRDF LUT, then the gather-minimal layouts the fast shading path
samples: RGBE quad rows of the specular chain (plain and child+parent
merged) and the SH9 projection of the irradiance map.  The base maps are
cached on disk (``$MO_CACHE_DIR``, default ``~/.mo_cache``), keyed by the
``.hdr`` file's content and the five sizes, as the reference does; the
port's files are named ``ibl-torch-<key>.npz`` so that neither package
reads the other's.  The fast maps are derived again after a load.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import os
import zipfile

import numpy as np
import torch

from ..device import resolve_device, sampling
from ..kernels import ibl as ibl_kernels
from ..utils import trace

logger = logging.getLogger("mo_renderer_tpu_torch")


@dataclasses.dataclass
class IBLMaps:
    """Tensors consumed by the shading pass (the reference's IBLMaps)."""

    environment_faces: torch.Tensor  # (6, S, S, 3)
    irradiance_faces: torch.Tensor  # (6, I, I, 3)
    specular_mips: sampling.MipCube
    brdf_lut: torch.Tensor  # (B, B, 3)
    specular_quad: sampling.MipCubeQuad
    specular_quad_merged: sampling.MipCubeQuadMerged
    irradiance_sh9: torch.Tensor  # (9, 3)


def _derive_fast_maps(irr, spec):
    """The gather-minimal layouts built from the base maps."""
    quad = sampling.MipCubeQuad.from_mipcube(spec)
    return dict(
        specular_quad=quad,
        specular_quad_merged=sampling.MipCubeQuadMerged.from_quad(quad),
        irradiance_sh9=ibl_kernels.sh9_project_cube(irr),
    )


class IBLResource:
    def __init__(
        self,
        name: str = "default_sky",
        resource_root: str | None = None,
        cubemap_size: int | None = None,
        irradiance_size: int = 128,
        specular_mips: int = 8,
        specular_samples: int | None = None,
        brdf_lut_size: int | None = None,
        device=None,
        cache: bool = True,
    ):
        from ..config import DEFAULT_CONFIG

        cfg = DEFAULT_CONFIG
        self.name = name
        self.resource_root = resource_root or cfg.resource_root
        self.cubemap_size = cubemap_size or cfg.ibl_cubemap_size
        self.irradiance_size = irradiance_size
        self.num_specular_mips = specular_mips
        self.specular_samples = specular_samples or cfg.ibl_specular_samples
        self.brdf_lut_size = brdf_lut_size or cfg.ibl_brdf_lut_size
        self.device = resolve_device(device) if device is not None else None
        self.use_cache = cache
        self._maps: IBLMaps | None = None
        self._equirect: np.ndarray | None = None
        self.hdr_path = os.path.join(
            self.resource_root, "tex", "env", f"{name}.hdr"
        )

    @classmethod
    def from_equirect(cls, equirect: np.ndarray, **kw) -> "IBLResource":
        """Environment from an in-memory (H, W, 3+) float panorama; not
        cached unless the caller passes ``cache=True``."""
        kw.setdefault("cache", False)
        res = cls(name="equirect", **kw)
        res._equirect = np.asarray(equirect, np.float32)
        return res

    def to(self, device) -> "IBLResource":
        """Set the device the maps are computed on; the Renderer calls
        this with its own device (maps already computed elsewhere raise)."""
        device = resolve_device(device)
        if self._maps is not None and self.device != device:
            raise RuntimeError(
                f"IBL maps already computed on {self.device}, not {device}"
            )
        self.device = device
        return self

    def ensure_computed(self) -> None:
        """The maps, loaded or computed on ``self.device`` once (the
        tracer's ``ibl_precompute`` span; with the tracer on it ends in a
        synchronise, so its time holds the device's work)."""
        if self._maps is not None:
            return
        if self.device is None:
            raise RuntimeError(
                "IBLResource has no device: pass device= or call .to(device)"
            )
        with trace.span("ibl_precompute"):
            self._compute()
            if trace.enabled() and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    def _compute(self) -> None:
        cached = self._load_cache() if self.use_cache else None
        if cached is not None:
            self._maps = cached
            logger.info("IBL loaded from cache (%s)", self.name)
            return
        if self._equirect is not None:
            equirect = self._equirect
        else:
            from . import image_io

            equirect = image_io.load_hdr(self.hdr_path)
        equirect = torch.as_tensor(
            np.asarray(equirect, np.float32), device=self.device
        )
        logger.info(
            "IBL precompute on %s: env %s -> cube %d, irradiance %d, "
            "%d specular mips x %d samples, BRDF LUT %d", self.device,
            tuple(equirect.shape), self.cubemap_size, self.irradiance_size,
            self.num_specular_mips, self.specular_samples, self.brdf_lut_size,
        )
        env = ibl_kernels.equirect_to_cubemap(equirect, self.cubemap_size)[..., :3]
        irr = ibl_kernels.irradiance_map(env, self.irradiance_size)
        spec = ibl_kernels.specular_prefilter(
            env, self.num_specular_mips, self.specular_samples
        )
        lut = ibl_kernels.brdf_lut(self.brdf_lut_size, device=self.device)
        self._maps = IBLMaps(
            environment_faces=env,
            irradiance_faces=irr,
            specular_mips=spec,
            brdf_lut=lut,
            **_derive_fast_maps(irr, spec),
        )
        if self.use_cache:
            self._save_cache()

    def maps(self) -> IBLMaps:
        self.ensure_computed()
        return self._maps

    # --- disk cache (ibl_resource.py:181-233) -------------------------------
    def _cache_path(self) -> str:
        """The key hashes the ``.hdr`` file (or, for ``from_equirect``, the
        panorama itself: two panoramas never share a file)."""
        try:
            if self._equirect is not None:
                content = self._equirect.tobytes()
            else:
                with open(self.hdr_path, "rb") as f:
                    content = f.read()
            file_hash = hashlib.sha1(content).hexdigest()[:12]
        except OSError:
            file_hash = "missing"
        key = (
            f"{self.name}-{file_hash}-{self.cubemap_size}-"
            f"{self.irradiance_size}-{self.num_specular_mips}-"
            f"{self.specular_samples}-{self.brdf_lut_size}"
        )
        cache_dir = os.environ.get(
            "MO_CACHE_DIR", os.path.join(os.path.expanduser("~"), ".mo_cache")
        )
        os.makedirs(cache_dir, exist_ok=True)
        return os.path.join(cache_dir, f"ibl-torch-{key}.npz")

    def _save_cache(self) -> None:
        m = self._maps
        arrays = {
            "environment": m.environment_faces.cpu().numpy(),
            "irradiance": m.irradiance_faces.cpu().numpy(),
            "brdf_lut": m.brdf_lut.cpu().numpy(),
        }
        for i in range(m.specular_mips.num_levels):
            arrays[f"spec_{i}"] = m.specular_mips.level(i).cpu().numpy()
        np.savez_compressed(self._cache_path(), **arrays)

    def _load_cache(self) -> IBLMaps | None:
        """The cached base maps on ``self.device``, or None when there is
        no file; a file that does not load logs a warning and is
        recomputed (and then overwritten)."""
        path = self._cache_path()
        if not os.path.exists(path):
            return None
        try:
            with np.load(path) as data:
                arrays = {k: data[k] for k in data.files}
            n_spec = sum(1 for k in arrays if k.startswith("spec_"))
            spec_levels = [arrays[f"spec_{i}"] for i in range(n_spec)]
            env, irr, lut = (arrays["environment"], arrays["irradiance"],
                             arrays["brdf_lut"])
        except (OSError, ValueError, KeyError, EOFError,
                zipfile.BadZipFile) as e:
            logger.warning("IBL cache load failed (%s); recomputing", e)
            return None

        def dev(a):
            return torch.from_numpy(a).to(self.device)

        irr_t = dev(irr)
        spec = sampling.MipCube.from_mips([dev(a) for a in spec_levels])
        return IBLMaps(
            environment_faces=dev(env),
            irradiance_faces=irr_t,
            specular_mips=spec,
            brdf_lut=dev(lut),
            **_derive_fast_maps(irr_t, spec),
        )
