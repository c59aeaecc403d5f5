"""flac_tpu_torch — the flac_tpu batched FLAC codec in PyTorch and CUDA.

A second package beside the JAX reference (`flac_tpu`): the same batched
encoder (presets -0..-8, mono to 8 channels, 8-24 bit) as plain PyTorch
tensor code on an explicit device, with the bit-pack deposit of the
quad layout as a hand-written CUDA kernel (`csrc/pack_fields64.cu`); and
the decoder (`decode_stream_tpu`, strict or tolerant) with its engines:
"device" (the native tile skip-walk on the host, the Rice code scan
`csrc/rice_codes.cu` and the restore `csrc/restore.cu` as hand-written CUDA
kernels), "fast" (the native full parse, then the restore kernel), "host"
(all-CPU native), "scan" (plain torch ops, the oracle) and "auto".
StreamEncoder keeps batches in flight while it writes earlier ones in
order (`pipeline_depth=6`, `super_batches=8`, as flac_tpu's).  `parallel`
shards frames over devices (`shard`: encode_blocks_dp, decode_frames_dp
on K3) and over processes in a gloo group (`multihost`: the frame-range
splice and the corpus runner, `python -m torch.distributed.run
--nproc-per-node N -m flac_tpu_torch.parallel.multihost`).

Entry points run on the GPU unless the caller passes `device="cpu"`; they
raise when asked for a GPU that is not there.
"""

import torch

# The autocorrelation product must stay full float32 (TF32 keeps ~3 decimal
# digits, far too few for the LPC analysis): pin both switches explicitly.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .config import EncoderConfig            # noqa: E402
from .decoder import decode_stream_tpu       # noqa: E402
from .encoder import StreamEncoder, encode_file_to_flac  # noqa: E402

__all__ = ["EncoderConfig", "StreamEncoder", "decode_stream_tpu",
           "encode_file_to_flac"]
__version__ = "0.1.0"
