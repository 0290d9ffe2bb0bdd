"""The benchmark's frozen metric arithmetic.

- Ray accounting (the repository's bench.py:104, the port's bench.py):
  each pixel sample launches a primary ray and, per bounce, an NEE
  shadow ray and a bounce ray.
- The span-sweep kernel's bound (the port's probes.span_bound): 128 x T x
  80 FP32 operations per visited (ray tile, cluster) span; bytes are each
  distinct cluster block's 41 x T floats once, the ray features and
  records once, and the span lists. H100 SXM data-sheet peaks.
- Interval arithmetic for the device's busy time.
"""

from __future__ import annotations

import numpy as np

PEAK_FP32_FLOPS = 67e12    # H100 SXM, FP32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12   # H100 SXM HBM3, bytes/s
FLOPS_PER_PAIR = 80        # 40 FMAs per ray x triangle
TILE_R = 128               # rays a kernel tile


def rays_per_pass(width: int, height: int, spp: int, bounces: int) -> int:
    return width * height * spp * (1 + 2 * bounces)


def span_bound(visits, clusters_read, t_blk, n_rays, index_bytes):
    """(bound_s, bound_by) of one span-sweep launch that walks `visits`
    spans over `clusters_read` distinct clusters of t_blk triangles."""
    ops_s = visits * TILE_R * t_blk * FLOPS_PER_PAIR / PEAK_FP32_FLOPS
    nbytes = (clusters_read * 41 * t_blk * 4 + n_rays * (16 + 2 * 8) * 4
              + index_bytes)
    bytes_s = nbytes / PEAK_HBM_BYTES
    return max(ops_s, bytes_s), ("operations" if ops_s >= bytes_s
                                 else "bytes")


def busy_runs(starts, ends):
    """The merged runs (starts, ends) that a set of intervals [starts[i],
    ends[i]) covers, in order."""
    if len(starts) == 0:
        return np.zeros(0), np.zeros(0)
    order = np.argsort(starts, kind="stable")
    s = np.asarray(starts, np.float64)[order]
    e = np.asarray(ends, np.float64)[order]
    # an interval opens a new run where it starts past every earlier end
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > np.maximum.accumulate(e)[:-1]
    return s[new], np.maximum.reduceat(e, np.flatnonzero(new))


def union_length(starts, ends) -> float:
    """Total length the intervals cover."""
    run_s, run_e = busy_runs(starts, ends)
    return float(np.sum(run_e - run_s))
