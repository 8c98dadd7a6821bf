"""The reference's four example programs (``examples/*.py``), driving the
port: ``sponza_scale``, ``dynamic_spawn``, ``multi_view_flythrough`` and
``pbr_ibl``.  Each runs as ``python -m mo_renderer_tpu_torch.examples.<name>``
on the card, keeps the reference's ``build_app`` / ``main`` split and
reads the same ``MO_*`` environment variables with the same defaults.

``sky`` is what the programs of the package (the examples, ``bench`` and
``eval_configs``) light a procedural scene with: the configured sky file
where it exists, else a synthetic sky, and which of the two it was.
``sync`` ends their timed windows.
"""

from __future__ import annotations

import os

import torch

from ..assets.ibl_resource import IBLResource
from ..assets.procedural import synthetic_sky

SYNTHETIC_SKY_SHAPE = (256, 512)  # (h, w) of the equirect gradient


def sky(config, device=None, cache: bool = True) -> tuple[IBLResource, str]:
    """(the IBL resource, its name): ``<resource_root>/tex/env/
    <ibl_env_name>.hdr`` where the file exists, else
    ``IBLResource.from_equirect`` of ``synthetic_sky``, named "synthetic".
    The IBL sizes are the config's (cube, specular samples, BRDF LUT) and
    the resource's defaults (128 irradiance texels, 8 specular mips), the
    last two cut to what the cube has: a config with a small cube makes a
    small sky.  ``cache`` is the file's disk cache (the synthetic sky is
    never cached)."""
    cube = config.ibl_cubemap_size
    sizes = dict(
        cubemap_size=cube,
        irradiance_size=min(128, cube),
        specular_mips=min(8, cube.bit_length()),
        specular_samples=config.ibl_specular_samples,
        brdf_lut_size=config.ibl_brdf_lut_size,
        device=device,
    )
    name = f"{config.ibl_env_name}.hdr"
    if os.path.isfile(os.path.join(config.resource_root, "tex", "env", name)):
        return IBLResource(name=config.ibl_env_name,
                           resource_root=config.resource_root, cache=cache,
                           **sizes), name
    return (IBLResource.from_equirect(synthetic_sky(*SYNTHETIC_SKY_SHAPE),
                                      **sizes), "synthetic")


def sync(t) -> None:
    """Wait until the device has computed ``t``: a timer stopped before
    that times only the host's issue of the work.  CPU ops return done."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
