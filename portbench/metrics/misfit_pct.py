"""Share of the window's frames that misfit the quad layout and were
encoded again in the safe one: StreamEncoder.misfit_frames over the
frames encoded."""


def read(run):
    return 100.0 * sum(f.misfits for f in run.files) / run.frames
