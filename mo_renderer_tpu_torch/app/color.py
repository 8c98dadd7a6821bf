"""FColor — RGBA f32 color (mo_core/src/color.rs)."""

from __future__ import annotations

import numpy as np


class FColor:
    __slots__ = ("r", "g", "b", "a")

    def __init__(self, r=0.0, g=0.0, b=0.0, a=1.0):
        self.r, self.g, self.b, self.a = float(r), float(g), float(b), float(a)

    # --- constructors (color.rs:20-120) ---------------------------------
    @staticmethod
    def rgb(r, g, b) -> "FColor":
        return FColor(r, g, b, 1.0)

    @staticmethod
    def rgba(r, g, b, a) -> "FColor":
        return FColor(r, g, b, a)

    @staticmethod
    def red() -> "FColor":
        return FColor.rgb(1.0, 0.0, 0.0)

    @staticmethod
    def green() -> "FColor":
        return FColor.rgb(0.0, 1.0, 0.0)

    @staticmethod
    def blue() -> "FColor":
        return FColor.rgb(0.0, 0.0, 1.0)

    @staticmethod
    def white() -> "FColor":
        return FColor.rgb(1.0, 1.0, 1.0)

    @staticmethod
    def black() -> "FColor":
        return FColor.rgb(0.0, 0.0, 0.0)

    @staticmethod
    def yellow() -> "FColor":
        return FColor.rgb(1.0, 1.0, 0.0)

    @staticmethod
    def cyan() -> "FColor":
        return FColor.rgb(0.0, 1.0, 1.0)

    @staticmethod
    def magenta() -> "FColor":
        return FColor.rgb(1.0, 0.0, 1.0)

    @staticmethod
    def gray() -> "FColor":
        return FColor.rgb(0.5, 0.5, 0.5)

    @staticmethod
    def orange() -> "FColor":
        return FColor.rgb(1.0, 0.5, 0.0)

    # --- operators (color.rs Mul<f32>, Index, From) ---------------------
    def __mul__(self, s: float) -> "FColor":
        return FColor(self.r * s, self.g * s, self.b * s, self.a * s)

    __rmul__ = __mul__

    def __getitem__(self, i: int) -> float:
        return (self.r, self.g, self.b, self.a)[i]

    def __iter__(self):
        return iter((self.r, self.g, self.b, self.a))

    def __eq__(self, other):
        return tuple(self) == tuple(other)

    def __repr__(self):
        return f"FColor({self.r}, {self.g}, {self.b}, {self.a})"

    @staticmethod
    def from_array(a) -> "FColor":
        a = list(a)
        if len(a) == 3:
            return FColor(a[0], a[1], a[2], 1.0)
        return FColor(*a[:4])

    def to_array(self) -> np.ndarray:
        return np.array([self.r, self.g, self.b, self.a], dtype=np.float32)
