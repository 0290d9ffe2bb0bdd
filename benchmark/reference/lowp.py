"""The control: the plain reference computed in bfloat16, the precision
next below the float32 the configurations state.

Inside `bfloat16()` every floating operation still takes float32 inputs
and computes as PyTorch does, but its result is rounded to bfloat16 (and
kept in a float32 tensor), forward and backward alike: each intermediate
holds bfloat16's 8 significant bits. Views are left as they are; an
in-place operation rounds the tensor it wrote.
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map


def _round(x):
    if isinstance(x, torch.Tensor) and x.dtype == torch.float32:
        return x.to(torch.bfloat16).to(torch.float32)
    return x


class _Bfloat16(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view:
            return out
        written = [a.name for a in func._schema.arguments
                   if a.alias_info is not None and a.alias_info.is_write]
        if written:
            named = dict(zip((a.name for a in func._schema.arguments), args))
            named.update(kwargs or {})
            for name in written:
                x = named.get(name)
                if isinstance(x, torch.Tensor) and x.dtype == torch.float32:
                    x.copy_(_round(x))
            return out
        return tree_map(_round, out)


def bfloat16():
    """Context in which the reference computes in bfloat16."""
    return _Bfloat16()
