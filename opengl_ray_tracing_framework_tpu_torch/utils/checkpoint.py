"""Checkpoint / resume of the progressive render state (PyTorch port of
opengl_ray_tracing_framework_tpu.utils.checkpoint).

The reference restarts accumulation from zero on any perturbation and can
only persist a tone-mapped PNG (Utility.h:19-30); here the running-mean
accumulator and its sample count round-trip through one npz file, so a
long converging render survives a restart.

The file layout is the JAX package's: `accum` float32 (H, W, 3) and
`n_samples` an int32 0-d array. A checkpoint written by either package
resumes in the other. The port's RenderState keeps n_samples as an int.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import resolve_device


def save_render_state(path: str, state) -> None:
    np.savez_compressed(
        path,
        accum=state.accum.detach().cpu().numpy().astype(np.float32),
        n_samples=np.asarray(int(state.n_samples), np.int32))


def load_render_state(path: str, device=None):
    """The RenderState saved at `path`, on the card unless a device is
    named."""
    from ..render import RenderState
    with np.load(path) as z:
        return RenderState(
            accum=torch.tensor(z["accum"], dtype=torch.float32,
                               device=resolve_device(device)),
            n_samples=int(z["n_samples"]))
