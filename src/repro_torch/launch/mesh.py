"""Meshes as named axis shapes (the port of ``repro/launch/mesh.py``).

A mesh here is axis names with their sizes and nothing behind them: the
dry-run prices a cell on a mesh (``launch/shardings.py``,
``launch/roofline.py``) without building devices, since one card has no
others to build.  ``ONE_CARD`` is this machine; the two production
shapes are the reference's, (16, 16) over ("data", "model") and
(2, 16, 16) over ("pod", "data", "model").
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, as a JAX mesh's ``shape``."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        """Number of devices (a JAX mesh's ``devices.size``)."""
        return math.prod(self.sizes)


def make_mesh(shape, axes) -> Mesh:
    return Mesh(tuple(axes), tuple(int(n) for n in shape))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_mesh((16, 16), ("data", "model"))


ONE_CARD = make_mesh((1, 1), ("data", "model"))
# the dry-run's --mesh choices
MESHES = {"one-card": ONE_CARD, "pod": make_production_mesh(),
          "two-pods": make_production_mesh(multi_pod=True)}


def dp_axes(mesh) -> tuple[str, ...]:
    """Data-parallel axes: ('pod', 'data') on the multi-pod mesh."""
    return tuple(a for a in mesh.shape if a in ("pod", "data"))


def all_axes(mesh) -> tuple[str, ...]:
    return tuple(mesh.shape)


def dp_size(mesh) -> int:
    """Size of the data-parallel axes of ``mesh``."""
    return math.prod(mesh.shape[a] for a in dp_axes(mesh))
