"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout on a machine with the cell's CUDA cards.
With --trace 0 it prints the cell's end-to-end metrics, with --trace 1
its per-layer metrics from a torch.profiler trace of the window.  The
last line of standard output is one JSON object; the last lines of
standard error are the numbers `correct` compares, each beside its
limit.  It exits non-zero with no result where the cards are missing or
fewer than the cell asks for, and where the process holds `jax`,
`jaxlib`, `flax` or `flac_tpu` once the window has closed.

--fault lsb|flip|half breaks the run underneath for the checks of the
check (portbench/tests): the input's lowest bit dropped before encoding
(the control), one bit of the written frames flipped, half of each batch
left out.  The benchmark's own runs never take it.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def keep_freed_memory() -> None:
    """Large blocks from the heap, and freed ones kept for the next: the
    window's files are hundreds of MB, which glibc would else map afresh
    and unmap for each copy, so every file would fault its pages in anew
    (a cost that swings with the host's load, not with the encode's)."""
    import ctypes
    import ctypes.util
    try:
        libc = ctypes.CDLL(ctypes.util.find_library("c"))
        libc.mallopt(-4, 0)              # M_MMAP_MAX: no mapped blocks
        libc.mallopt(-1, 2**31 - 1)      # M_TRIM_THRESHOLD: keep the top
    except (OSError, AttributeError):
        pass                             # not glibc: its own policy


def main(argv=None) -> int:
    keep_freed_memory()
    import torch
    # one encode flow in one process: torch's host work on one thread
    # beside the program's own MD5 thread, so the run does not hang on
    # the slowest of a pool of workers on a host whose cores it shares
    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)
    from portbench import cells, harness
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--fault", choices=harness.FAULTS)
    args = ap.parse_args(argv)
    cell = cells.load_cell(ROOT / "BENCHMARK.json", args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA card(s); this "
              f"machine has {have}", file=sys.stderr)
        return 2
    result = harness.run_cell(
        cell, args.seed, args.seconds, bool(args.trace), t0=T0,
        fault=args.fault, log=lambda s: print(s, file=sys.stderr))
    result.pop("_run")
    bad = harness.forbidden_modules()
    if bad:
        print(f"modules loaded in this process: {bad}", file=sys.stderr)
        return 3
    for name, (value, limit) in result["checks"].items():
        print(f"check {name} {value} limit {limit}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
