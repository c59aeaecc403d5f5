#!/usr/bin/env python
"""frame_diff: how many frames of two FLAC streams of the same audio
differ, and their sizes, with flac_tpu_torch's host decoder only (no JAX).

Usage: python tools/frame_diff.py a.flac b.flac

Prints one JSON line: the frames of each stream, the frames whose bytes
differ (and the first few indices), each stream's bytes and the size
change of b against a.  Both streams must decode to the same samples.
"""
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(a_path: str, b_path: str) -> int:
    from flac_tpu_torch import decode_stream_tpu
    data = [open(p, "rb").read() for p in (a_path, b_path)]
    dec = [decode_stream_tpu(d, engine="host", device="cpu") for d in data]
    if not all(s.md5_ok for s in dec) or not np.array_equal(
            dec[0].samples, dec[1].samples):
        print(json.dumps({"error": "the streams do not decode to the same "
                                   "samples with their MD5"}))
        return 1
    fa, fb = dec[0].frames, dec[1].frames
    differ = [i for i, (x, y) in enumerate(zip(fa, fb))
              if data[0][x["offset"]:x["offset"] + x["size"]]
              != data[1][y["offset"]:y["offset"] + y["size"]]]
    print(json.dumps({"a": a_path, "b": b_path, "frames": [len(fa), len(fb)],
                      "differing_frames": len(differ),
                      "first_differing": differ[:10],
                      "bytes": [len(data[0]), len(data[1])],
                      "size_change": len(data[1]) / len(data[0]) - 1}))
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:3]))
