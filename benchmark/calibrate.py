"""The readings a cell's limits are set from, many seeds in one process.

    python3 benchmark/calibrate.py --workload <cell> --seconds <s> \
        --seeds <n,n,...> --control-seeds <n,n,...>

For each seed: the program's window of --seconds on the seed's draws,
then the compared numbers of its outputs (the lower readings); for each
control seed, the same window's draws with the reference computed in
bfloat16 put in the program's place (the upper readings). One JSON line
a reading (run.readings). The benchmark's own runs never run this.
"""

import argparse
import json
import sys
from pathlib import Path

if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parents[1])

import torch  # noqa: E402

from benchmark import cell as cells, run  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    seeds = [int(x) for x in args.seeds.split(",") if x]
    controls = [int(x) for x in args.control_seeds.split(",") if x]
    for reading in run.readings(cells.load(args.workload), args.seconds,
                                seeds, controls, torch.device("cuda", 0)):
        print(json.dumps(reading), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
