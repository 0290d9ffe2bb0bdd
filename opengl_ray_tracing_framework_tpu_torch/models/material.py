"""Disney-principled material model (PyTorch port of
opengl_ray_tracing_framework_tpu.models.material).

The parameter set of the reference (src/core/Material.h:25-50) plus a
participating-medium description (MediumType, Material.h:17-23).
Materials live in a small MaterialTable of (M, ...) tensors indexed by a
per-triangle material id; a per-hit fetch is a plain index into the
table (the JAX package's one-hot contraction is a TPU gather workaround
and equals the index exactly for its 0/1 weights).
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import NamedTuple

import torch

MEDIUM_NONE = 0
MEDIUM_ABSORB = 1
MEDIUM_SCATTER = 2
MEDIUM_EMISSIVE = 3


class Material(NamedTuple):
    """One material (or a batch: every field broadcasts over leading dims).

    Scalar fields are float32 tensors; colors are (..., 3); medium_type is
    int32. Defaults mirror Material.h:25-50.
    """

    emissive: torch.Tensor
    base_color: torch.Tensor
    subsurface: torch.Tensor
    metallic: torch.Tensor
    specular: torch.Tensor
    specular_tint: torch.Tensor
    roughness: torch.Tensor
    anisotropic: torch.Tensor
    sheen: torch.Tensor
    sheen_tint: torch.Tensor
    clearcoat: torch.Tensor
    clearcoat_gloss: torch.Tensor
    ior: torch.Tensor
    transmission: torch.Tensor
    medium_color: torch.Tensor
    medium_type: torch.Tensor
    medium_density: torch.Tensor
    medium_anisotropy: torch.Tensor

    @staticmethod
    def make(
        emissive=(0.0, 0.0, 0.0),
        base_color=(1.0, 1.0, 1.0),
        subsurface=0.0,
        metallic=0.0,
        specular=0.0,
        specular_tint=0.0,
        roughness=0.0,
        anisotropic=0.0,
        sheen=0.0,
        sheen_tint=0.0,
        clearcoat=0.0,
        clearcoat_gloss=0.0,
        ior=1.0,
        transmission=0.0,
        medium_color=(1.0, 1.0, 1.0),
        medium_type=MEDIUM_NONE,
        medium_density=0.0,
        medium_anisotropy=0.0,
    ) -> "Material":
        f = lambda x: torch.as_tensor(x, dtype=torch.float32)
        return Material(
            emissive=f(emissive),
            base_color=f(base_color),
            subsurface=f(subsurface),
            metallic=f(metallic),
            specular=f(specular),
            specular_tint=f(specular_tint),
            roughness=f(roughness),
            anisotropic=f(anisotropic),
            sheen=f(sheen),
            sheen_tint=f(sheen_tint),
            clearcoat=f(clearcoat),
            clearcoat_gloss=f(clearcoat_gloss),
            ior=f(ior),
            transmission=f(transmission),
            medium_color=f(medium_color),
            medium_type=torch.as_tensor(medium_type, dtype=torch.int32),
            medium_density=f(medium_density),
            medium_anisotropy=f(medium_anisotropy),
        )

    def alpha_xy(self):
        """Anisotropic GGX roughness (ax, ay), derived like glsl:205-207."""
        aspect = torch.sqrt(1.0 - self.anisotropic * 0.9)
        r2 = torch.square(self.roughness)
        ax = torch.clamp(r2 / aspect, min=0.001)
        ay = torch.clamp(r2 * aspect, min=0.001)
        return ax, ay


# The packed table's layout (MaterialTable.packed): each Material field in
# order, the colors three columns wide; csrc/shade.cu reads the same columns.
_WIDTHS = [3 if f in ("emissive", "base_color", "medium_color") else 1
           for f in Material._fields]
PACKED_COLUMNS = dict(zip(Material._fields,
                          itertools.accumulate([0] + _WIDTHS[:-1])))
PACKED_WIDTH = sum(_WIDTHS)


@dataclasses.dataclass
class MaterialTable:
    """Stacked materials: a Material whose fields have leading dim M.

    A table is not edited in place: replace_material and to() make new
    tables, so what `packed` caches follows every edit."""

    mat: Material

    @staticmethod
    def stack(materials: list) -> "MaterialTable":
        return MaterialTable(mat=Material(*(
            torch.stack(list(fields)) for fields in zip(*materials))))

    @property
    def count(self) -> int:
        return self.mat.emissive.shape[0]

    @functools.cached_property
    def packed(self) -> torch.Tensor:
        """Every field as one contiguous (M, PACKED_WIDTH) float32 table,
        packed once per table: csrc/shade.cu reads a lane's material by
        its id from it. medium_type is stored as a float, exact for the
        small ids it holds. Detached: the kernels that read it have no
        backward."""
        return torch.cat([x.detach().reshape(x.shape[0], -1).to(torch.float32)
                          for x in self.mat], dim=1).contiguous()

    def to(self, device) -> "MaterialTable":
        return MaterialTable(mat=Material(*(x.to(device) for x in self.mat)))

    def gather(self, idx: torch.Tensor) -> Material:
        """Per-hit material fetch: idx (...,) integer -> Material batch."""
        safe = torch.clamp(idx, 0, self.count - 1).long()
        return Material(*(x[safe] for x in self.mat))

    def replace_material(self, slot: int, material: Material
                         ) -> "MaterialTable":
        """A new table with `slot` set to `material`; this one is left as it
        was. The analogue of the reference's RefreshTriangleMaterial + TBO
        re-upload (Triangle.h:133-151): a live material edit."""
        def put(tab, m):
            new = tab.clone()
            new[slot] = m.to(device=tab.device, dtype=tab.dtype)
            return new

        return MaterialTable(mat=Material(*map(put, self.mat, material)))


# Built-in material presets (Scene.h:53-109), reproduced 1:1.


def preset_materials() -> dict:
    return {
        "plane": Material.make(base_color=(0.73, 0.73, 0.73), specular=1.0,
                               ior=1.79, metallic=0.2),
        "white": Material.make(base_color=(0.73, 0.73, 0.73), roughness=0.5,
                               specular=0.5),
        "jade": Material.make(base_color=(0.55, 0.78, 0.55), specular=1.0,
                              ior=1.79, subsurface=1.0),
        "golden": Material.make(base_color=(0.75, 0.7, 0.15), roughness=0.05,
                                specular=1.0, metallic=1.0),
        "copper": Material.make(
            base_color=(238.0 / 255.0, 158.0 / 255.0, 137.0 / 255.0),
            roughness=0.2, specular=1.0, ior=1.21901, metallic=1.0),
        "glass": Material.make(base_color=(1.0, 1.0, 1.0), specular=1.0,
                               transmission=1.0, ior=1.5, roughness=0.02),
        "brown_glass": Material.make(
            base_color=(1.0, 1.0, 1.0), medium_type=MEDIUM_ABSORB,
            medium_color=(0.905, 0.63, 0.3), medium_density=1.0,
            specular=1.0, transmission=0.957, ior=1.45, roughness=0.1),
        "tear_glass": Material.make(
            base_color=(1.0, 1.0, 1.0), medium_color=(0.085, 0.917, 0.848),
            medium_density=1.0, medium_type=MEDIUM_ABSORB, specular=1.0,
            transmission=0.917, ior=1.45),
        "tear_glass_emissive": Material.make(
            base_color=(1.0, 1.0, 1.0), medium_color=(0.085, 0.917, 0.848),
            medium_density=0.25, medium_type=MEDIUM_EMISSIVE, specular=1.0,
            transmission=0.917, ior=1.45),
    }
