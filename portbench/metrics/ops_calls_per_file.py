"""Encode program calls that ran op by op (a key's first call: a final
block of a new size, a batch shape not seen before) a file: the growth of
the program's set of keys seen (flac_tpu_torch.encoder._PROGRAMS.seen)
over the window, divided by the files."""


def read(run):
    return sum(f.ops_calls for f in run.files) / len(run.files)
