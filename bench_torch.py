#!/usr/bin/env python3
"""Headline benchmark of the PyTorch port on the card: rays/s of the
reference frame, fwd and fwd+bwd, as one JSON line (the port's counterpart
of bench.py; knobs and fields in opengl_ray_tracing_framework_tpu_torch/
bench.py).

    python3 bench_torch.py                          # sweep tracer, the card
    BENCH_TRACER=schedule python3 bench_torch.py    # the schedule tracer
"""

import sys

from opengl_ray_tracing_framework_tpu_torch.bench import main

if __name__ == "__main__":
    sys.exit(main())
