"""The plain reference's closest hit for scenes of millions of triangles.

cast.py's Caster slab-tests a chunk of 32,768 rays against every box of
128 triangles at once: at 5.2 million triangles (40,960 boxes) that is a
16 GB tensor. BlockCaster is the same brute-force closest hit (the same
Morton-ordered boxes, ray_triangle, T_MIN, pull-back and prune slack,
nearest box first) with its rays taken in chunks sized to a memory
budget, and the slab test taken an axis at a time. Plain PyTorch and
numpy; nothing of the program.
"""

from __future__ import annotations

import torch

from .cast import INF, Caster

BUDGET = 2 << 30    # bytes a chunk's (rays x boxes) tensors may hold
PAIR_BYTES = 48     # bytes a (ray, box) pair holds at a chunk's peak:
                    # the slab test's float32 temporaries, the entry
                    # distances and their sort (values and int64 order)


class BlockCaster(Caster):
    """Caster's closest hit in ray chunks of BUDGET / (PAIR_BYTES x
    boxes) rays."""

    @classmethod
    def of(cls, caster: Caster, budget: int = BUDGET) -> "BlockCaster":
        """The boxes of a built Caster, without building them again."""
        out = cls.__new__(cls)
        out.__dict__.update(caster.__dict__)
        out.ray_chunk = max(1, budget // (PAIR_BYTES
                                          * caster.box_lo.shape[0]))
        return out

    def _entry(self, origin, direction):
        """(R, C) conservative entry distance of each ray into each box,
        INF where the slab test misses: Caster._entry's values, an axis at
        a time."""
        small = torch.abs(direction) < 1e-12
        inv = 1.0 / torch.where(small, torch.where(direction < 0, -1e-12,
                                                   1e-12), direction)
        t0 = t1 = None
        for ax in range(3):
            near = ((self.box_lo[None, :, ax] - origin[:, None, ax])
                    * inv[:, None, ax])
            far = ((self.box_hi[None, :, ax] - origin[:, None, ax])
                   * inv[:, None, ax])
            lo, hi = torch.minimum(near, far), torch.maximum(near, far)
            del near, far
            t0 = lo if t0 is None else torch.maximum(t0, lo)
            t1 = hi if t1 is None else torch.minimum(t1, hi)
            del lo, hi
        visit = (t1 >= t0) & (t1 > 0.0)
        return torch.where(visit, torch.clamp(t0, min=0.0), INF)

    def closest_hit(self, origin, direction, mask=None, any_hit=False):
        """(t, tri, inside) per ray: Caster.closest_hit on each chunk of
        ray_chunk rays that holds a ray masked on."""
        r, dev = origin.shape[0], origin.device
        if mask is None:
            mask = torch.ones(r, dtype=torch.bool, device=dev)
        out = (torch.full((r,), INF, dtype=origin.dtype, device=dev),
               torch.full((r,), -1, dtype=torch.int64, device=dev),
               torch.zeros(r, dtype=torch.bool, device=dev))
        for lo in range(0, r, self.ray_chunk):
            sl = slice(lo, lo + self.ray_chunk)
            if bool(mask[sl].any()):
                got = super().closest_hit(origin[sl], direction[sl],
                                          mask[sl], any_hit)
                for whole, part in zip(out, got):
                    whole[sl] = part
        return out
