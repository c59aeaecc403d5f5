"""Device milliseconds of every kernel the trace holds (the program's
hand kernels and the torch kernels beside them), per MB of source PCM
encoded in the window."""


def read(run):
    if run.trace is None:
        return None
    ks = run.trace.kernel_seconds()
    if not ks:
        return None
    return sum(ks.values()) * 1e3 / (run.pcm_bytes / 1e6)
