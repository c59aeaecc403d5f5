"""The encode kernels' share of their roofline: the sum of each kernel's
bound over the sum of its device time, over the launches of K1 and K4-K12
that the trace holds.

Each kernel's bound is work.window_bounds over the window's program calls
(the harness's model of StreamEncoder's batching: traffic.units of each
file, the safe passes of its misfit frames), with the sums of the
benchmark's parse of each written stream.  The model's launches of each
kernel are held to the program's launch counters first: where they
differ, the program batches otherwise than the model, the bound would
stand for other work, and the metric is left out (the log says which
kernel).  Where the trace holds fewer launches of a kernel than the
counter says ran (CUPTI can drop records), its bound is scaled down by the
same share, so a dropped record drops its bound too."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent.parent))

from portbench import work  # noqa: E402


def read(run):
    if run.trace is None or not run.calls or not any(run.launches.values()):
        return None
    model = work.call_launches(run.enc, run.calls)
    differ = {k: (model.get(k, 0), ran) for k, ran in run.launches.items()
              if model.get(k, 0) != ran}
    if differ:
        run.log(f"encode_kernels_roofline left out: the model's launches "
                f"differ from the program's (model, program): {differ}")
        return None
    bounds = work.window_bounds(run.enc, run.calls)
    num = den = 0.0
    for k, name in work.KERNELS.items():
        traced = run.trace.kernel_launches(name)
        ran = run.launches.get(k, 0)
        if not traced or not ran:
            continue
        t = sum(run.trace.kernel_seconds(name).values())
        num += bounds[k]["bound_ms"] / 1e3 * min(1.0, traced / ran)
        den += t
    if den <= 0:
        return None
    return 100.0 * num / den
