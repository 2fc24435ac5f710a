"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Exits non-zero, with no result, where no card is found (or fewer than the
cell asks for), where the port cannot be imported, or where a JAX module
is loaded once the window has closed. Otherwise prints, as the last line
of standard output, one JSON object: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics, or with --trace 1 its per-layer
ones), `device`, with --trace 1 `breakdown`, and last `checks`, each
number compared beside its limit; the checks are also the last lines of
standard error.
"""

import time

T0 = time.perf_counter()  # set-up runs from here to the window's start

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness  # noqa: E402


def power_limit() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = harness.load_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    t_import = time.perf_counter() - T0
    cell.device = torch.device("cuda", 0)
    torch.cuda.set_device(cell.device)
    out = harness.driver(cell).run(cell)
    setup_s = cell.window_start - T0
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: loaded after the window: {', '.join(found)}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips}
    line = harness.result(cell, out, setup_s, device)
    notes = [f"card {power_limit()}", f"setup_s {setup_s!r} (imports {t_import!r})"]
    for note in notes + cell.notes:
        print(note, file=sys.stderr)
    for check in harness.check_lines(line):
        print(check, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
