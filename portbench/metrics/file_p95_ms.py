"""95th percentile of a file's time, from its StreamEncoder's creation to
finish() returning (the benchmark's spans, host clock), over every file
of the window."""

import statistics


def read(run):
    times = [(f.end - f.start) * 1e3 for f in run.files]
    if len(times) < 20:
        return None
    return statistics.quantiles(times, n=20)[18]
