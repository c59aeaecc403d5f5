"""Share of the window spent in StreamEncoder.finish() (the drain of the
batches in flight, the final block, the STREAMINFO patch): the
benchmark's span around each call, host clock."""


def read(run):
    return 100.0 * sum(f.end - f.processed for f in run.files) / run.window_s
