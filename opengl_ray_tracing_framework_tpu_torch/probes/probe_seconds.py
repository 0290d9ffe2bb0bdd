"""Device microseconds of the per-CTA copy (K4a, tile 128, with and
without span rows), the chained-lookup and block-sum probe kernels (K4c-2,
K4c-3), the shared-memory probe (K4c-1) at 512 B and at 227 KB and, where
the tree has it, the empty one-CTA kernel that measures the card's launch
floor; nothing else, each held to its plain version first.

    python -m opengl_ray_tracing_framework_tpu_torch.probes.probe_seconds

Times are probes.hbm_ms (the inputs come from HBM). Where the tree has
probe_chained, K4c-2 is also timed with 0 steps: its staging and its
index and result traffic without a lookup. Two trees of the
repository are compared only inside one call on one card, in turns
(parent, change, change, parent), each run from its own tree's root. This
module uses only entry points every tree of the port has since the probes
came (a tree without probe_chained runs its chained lookups as
probe_gather(..., steps=8); one without launch_floor_ms has no floor to
time), so a copy of it runs in an older tree too.
It prints one JSON line: {case: microseconds}.
"""

from __future__ import annotations

import json

import torch

from . import card_perf, device_line, gather, hbm_ms, launch_overhead

STEPS = 8


def _chained():
    chained = getattr(gather, "probe_chained", None)
    return chained or (lambda t, i: gather.probe_gather(t, i, steps=STEPS))


def _columns_differ(device, s, cols=128):
    """table[i, j] = (7 i + 13 j) % s and random (s, cols) indices."""
    gen = torch.Generator(device="cpu").manual_seed(0)
    i = torch.arange(s)[:, None]
    table = ((7 * i + 13 * torch.arange(cols)) % s).float()
    idx = torch.randint(0, s, (s, cols), generator=gen, dtype=torch.int32)
    return table.to(device), idx.to(device)


def run(device="cuda"):
    device = torch.device(device)
    chained = _chained()
    out = {}
    rayfeat, best = launch_overhead.make_inputs(device)
    want = launch_overhead.probe_copy_plain(rayfeat, best, 128)
    for label, extra in (
            ("no span rows", ()),
            ("span rows", launch_overhead.make_span_rows(
                device, launch_overhead.N_ROWS, 128))):
        if not torch.equal(launch_overhead.probe_copy(rayfeat, best, 128,
                                                      *extra), want):
            raise RuntimeError(f"probe_seconds: copy ({label}) differs")
        out[f"K4a tile 128, {label}"] = hbm_ms(
            lambda *x: launch_overhead.probe_copy(x[0], x[1], 128, *x[2:]),
            (rayfeat, best, *extra)) * 1e3
    for s in (512, 3000, 4096):
        table, idx = _columns_differ(device, s)
        got = chained(table, idx)
        if not torch.equal(got, gather.probe_gather_plain(table, idx, STEPS)):
            raise RuntimeError(f"probe_seconds: chained S={s} differs")
        out[f"K4c-2 S={s}"] = hbm_ms(chained, (table, idx)) * 1e3
        if hasattr(gather, "probe_chained"):
            out[f"K4c-2 S={s}, 0 steps"] = hbm_ms(
                lambda t, i: gather.probe_chained(t, i, 0), (table, idx)) * 1e3
    for g in (1, card_perf.N_SMS):
        table, starts = card_perf.make_stream_inputs(device, g)
        if not torch.equal(card_perf.probe_stream(table, starts),
                           card_perf.probe_stream_plain(table, starts)):
            raise RuntimeError(f"probe_seconds: block sums G={g} differ")
        out[f"K4c-3 G={g}"] = hbm_ms(card_perf.probe_stream,
                                     (table, starts)) * 1e3
    for n_bytes in (512, 227 * 1024):
        out[f"K4c-1 {n_bytes} B"] = hbm_ms(
            lambda: card_perf.probe_smem(n_bytes, device)) * 1e3
    if hasattr(card_perf, "launch_floor_ms"):
        out["launch floor"] = card_perf.launch_floor_ms(device) * 1e3
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    print(device_line())
    run()
