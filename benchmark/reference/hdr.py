"""The environment importance-sampling cache and fetch table of the plain
reference: a frozen copy of the port's models/hdr.py (build_hdr_cache,
build_env_fetch), so the reference derives these tables from the raw HDR
image itself and takes none of the program's.

Host-side equivalents of:
- calculateHdrCache (src/core/Utility.h:33-131): the inverse-CDF table used
  by the kernel's environment importance sampling (SampleHdr glsl:635-646,
  hdrPdf glsl:1173-1186).

Cache layout (identical to the reference texture): an (H, W, 3) float32
array where channel R,G at cache[i, j] hold the inverse-CDF image sample
position (x/W, y/H) for stratified uniforms (xi_1 = i/H, xi_2 = j/W), and
channel B at cache[i, j] holds the *image-space* discrete pdf of pixel
(i, j). R,G form a lookup table addressed by uniforms; B is addressed by
direction — two tables packed in one texture, exactly like the reference.
"""

from __future__ import annotations

import numpy as np


def build_hdr_cache(hdr: np.ndarray) -> np.ndarray:
    """Importance-sampling cache (calculateHdrCache, Utility.h:33-131).

    hdr: (H, W, 3) float32 radiance. Returns (H, W, 3) float32 cache.
    """
    hdr = np.asarray(hdr, np.float64)
    height, width = hdr.shape[:2]

    # Luminance-proportional discrete pdf (Utility.h:40-54 uses .2/.7/.1).
    lum = 0.2 * hdr[..., 0] + 0.7 * hdr[..., 1] + 0.1 * hdr[..., 2]
    pdf = lum / max(lum.sum(), 1e-30)

    # Marginal over columns and its CDF (Utility.h:57-66).
    pdf_x = pdf.sum(axis=0)                       # (W,)
    cdf_x = np.cumsum(pdf_x)                      # (W,)

    # Conditional y | X=x CDF, stored per column (Utility.h:69-87).
    pdf_y_cond = pdf / np.maximum(pdf_x[None, :], 1e-30)   # (H, W)
    cdf_y_cond = np.cumsum(pdf_y_cond, axis=0)             # (H, W)

    # Inverse-CDF table for the stratified grid (Utility.h:90-115):
    # xi_1 = i/H picks column x via cdf_x; xi_2 = j/W picks row y via
    # cdf_y|x. lower_bound == searchsorted(side="left").
    xi_1 = np.arange(height, dtype=np.float64) / height
    xs = np.searchsorted(cdf_x, xi_1, side="left")         # (H,)
    xs = np.minimum(xs, width - 1)

    xi_2 = np.arange(width, dtype=np.float64) / width
    ys = np.empty((height, width), np.int64)
    for i in range(height):
        col = cdf_y_cond[:, xs[i]]
        ys[i] = np.searchsorted(col, xi_2, side="left")
    ys = np.minimum(ys, height - 1)

    cache = np.empty((height, width, 3), np.float32)
    cache[..., 0] = (xs[:, None] / width).astype(np.float32)
    cache[..., 1] = (ys / height).astype(np.float32)
    cache[..., 2] = pdf.astype(np.float32)
    return cache


def build_env_fetch(hdr: np.ndarray, cache: np.ndarray) -> np.ndarray:
    """Fused (H*W, 16) row-gather table for the in-loop env accesses.

    Columns: [map_r, map_g, map_b, pdf_img, cache_x, cache_y, pdf_sampled,
    sampled_r, sampled_g, sampled_b, 0...]. Texel index is the MAJOR axis:
    TPU gathers are fast along the sublane (major) axis and ~40x slower
    along the lane (minor) axis (measured 249.95 ms vs 6.42 ms per
    131072-index gather at this table size, exp/env_gather_probe.py) — the
    round-3 breakdown's dominant cost. pdf_img is the image-space pdf
    addressed by *pixel position* (the reference's hdrPdf addressing,
    glsl:1173-1186); pdf_sampled and sampled_rgb are the pdf and radiance
    of the texel the inverse-CDF sampler lands on, addressed by the
    *uniforms* (xi_1, xi_2) like cache_x/cache_y — so NEE gets sample
    position, its true pdf AND its radiance in ONE fetch (the reference
    pays three texture lookups: SampleHdr + hdrColor + hdrPdf,
    glsl:1382-1390). Gather cost is identical to an 8-wide row: the
    gathered rows pad to 128 lanes either way.
    """
    h, w = hdr.shape[:2]
    # cache stores xs/w and ys/h; recover the exact integer sample indices
    xs = np.clip(np.round(cache[..., 0].astype(np.float64) * w),
                 0, w - 1).astype(np.int64)
    ys = np.clip(np.round(cache[..., 1].astype(np.float64) * h),
                 0, h - 1).astype(np.int64)
    pdf_img = cache[..., 2]
    pdf_sampled = pdf_img[ys, xs]
    sampled_rgb = hdr[ys, xs]                    # (H, W, 3)
    flat = hdr.reshape(-1, 3)
    n = h * w
    z = np.zeros(n, np.float32)
    return np.stack([
        flat[:, 0], flat[:, 1], flat[:, 2],
        pdf_img.ravel(), cache[..., 0].ravel(), cache[..., 1].ravel(),
        pdf_sampled.ravel(),
        sampled_rgb[..., 0].ravel(), sampled_rgb[..., 1].ravel(),
        sampled_rgb[..., 2].ravel(), z, z, z, z, z, z,
    ], axis=-1).astype(np.float32)
