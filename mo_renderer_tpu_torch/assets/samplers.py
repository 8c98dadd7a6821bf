"""GlobalSamplers resource (mo_ecs/src/resource/global_samplers.rs:7-54).

On TPU there is no fixed-function sampler hardware: sampling is a gather
kernel (device/sampling.py).  This resource preserves the reference's API —
three linear samplers differing only in address (wrap) mode.
"""

from __future__ import annotations

import dataclasses
import enum


class AddressMode(enum.IntEnum):
    CLAMP_TO_EDGE = 0
    REPEAT = 1
    MIRRORED_REPEAT = 2


class Filter(enum.IntEnum):
    NEAREST = 0
    LINEAR = 1


@dataclasses.dataclass(frozen=True)
class Sampler:
    mag_filter: Filter = Filter.LINEAR
    min_filter: Filter = Filter.LINEAR
    address_mode: AddressMode = AddressMode.CLAMP_TO_EDGE


class GlobalSamplers:
    def __init__(self):
        self.linear_clamp_to_edge = Sampler(address_mode=AddressMode.CLAMP_TO_EDGE)
        self.linear_repeat = Sampler(address_mode=AddressMode.REPEAT)
        self.linear_mirrored_repeat = Sampler(address_mode=AddressMode.MIRRORED_REPEAT)
