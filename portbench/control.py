"""Readings that the limits of `correct` are set from (not run by the
benchmark's own runs):

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 ... [--controls 3]

On the card, at the cell's own size, for each seed: the number(s) a sound
run of the program gives (the lower readings), and for the first
`--controls` seeds the control and the faults (the upper readings):

  control   the reference put in the program's place, computed one
            precision below the configuration's float32: TF32;
  bfloat16  the program with `model.compute_dtype=bfloat16`, its own lower
            precision;
  faults    the driver's FAULTS planted where the program's result is
            produced (`half_batch`, and for scoring `answer_altered`); a
            state left unchanged reads 1 by construction and needs no run.

Each driver reads its own (`drivers/<driver>.py`, `readings`): meta cells
the checked steps alone (no window), the scoring cell as many requests as
a run checks, at the kept positions of the stream. One JSON line a reading
on standard output.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", type=int, default=3, help="seeds that also read controls")
    ap.add_argument("--requests", type=int, default=48,
                    help="answers compared, where the driver reads many")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    for n, seed in enumerate(args.seeds):
        cell = harness.load_cell(args.workload, seed, 0, False, device=torch.device("cuda", 0))
        t0 = time.perf_counter()
        for what, readings, notes in harness.driver(cell).readings(
                cell, n < args.controls, args.requests):
            print(json.dumps({"workload": cell.name, "seed": seed, "what": what,
                              "readings": readings, "notes": notes,
                              "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
