"""Host-side scene math (numpy float32, glam-compatible conventions).

Matrices are stored column-major as (4, 4) numpy arrays indexed
``m[col, row]`` to mirror glam's ``x_axis..w_axis`` layout — but for
ergonomics we keep them in standard mathematical row/col form ``m[row, col]``
and document every convention.  Transforming a point: ``m @ v``.
"""

from . import quat
from . import projections
from .transform import Transform

__all__ = ["quat", "projections", "Transform"]
