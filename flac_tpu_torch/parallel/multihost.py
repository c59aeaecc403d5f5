"""Multi-process scale-out: the process group, the corpus runner and the
ordered splice of one file's frame ranges.

Port of flac_tpu/parallel/multihost.py.  Two tiers, as in the reference:

- corpus tier: whole FILES shard round-robin across processes, with no
  traffic between them; each runs the single-process pipeline
  (StreamEncoder) on its own files.
- frame tier: for one large file, `encode_file_ranges` gives each process
  a contiguous frame RANGE, encoded with absolute frame numbers (through
  shard.encode_blocks_dp), so the blobs spliced in process order are the
  single-process stream's frames byte for byte; only the blobs' lengths
  cross between processes, so that each knows its offset.

`python -m torch.distributed.run --nproc-per-node 2 -m
flac_tpu_torch.parallel.multihost -5 -o OUT a.wav b.wav c.wav` runs the
corpus runner on two processes.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from .. import container, native
from ..config import EncoderConfig
from ..device import resolve_device
from ..encoder import StreamEncoder
from .shard import encode_blocks_dp


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> tuple[int, int]:
    """Join the process group when running on several processes; returns
    (process index, process count), (0, 1) with no group.

    Arguments left out are read from torchrun's variables: MASTER_ADDR and
    MASTER_PORT (the coordinator "host:port"), WORLD_SIZE and RANK.  With
    no coordinator either way, no group is created.

    The group's backend is gloo, whatever the devices: the only traffic
    between processes is one int64 a process (a blob's length, a host
    value) gathered from CPU tensors, and NCCL would need a GPU of its own
    for each process."""
    if coordinator is None and os.environ.get("MASTER_ADDR") \
            and os.environ.get("MASTER_PORT"):
        coordinator = (f"{os.environ['MASTER_ADDR']}:"
                       f"{os.environ['MASTER_PORT']}")
    if coordinator and not dist.is_initialized():
        num_processes = num_processes or int(
            os.environ.get("WORLD_SIZE", "1"))
        process_id = process_id if process_id is not None else int(
            os.environ.get("RANK", "0"))
        dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id)
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_device(device=None) -> torch.device:
    """`device`, or this process's GPU: cuda:{LOCAL_RANK % device count}
    (raises when there is none)."""
    if device is not None:
        return resolve_device(device)
    resolve_device("cuda")
    rank = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", rank % torch.cuda.device_count())


def host_file_shard(paths: list[str], host_id: int,
                    num_hosts: int) -> list[str]:
    """Round-robin file assignment (corpus tier)."""
    return [p for i, p in enumerate(paths) if i % num_hosts == host_id]


def encode_corpus(paths: list[str], cfg: EncoderConfig, out_dir: str,
                  *, batch_frames: int = 64, verify: bool = False,
                  host_id: int | None = None, num_hosts: int | None = None,
                  device=None) -> list[tuple[str, int]]:
    """Encode this process's share of a corpus, each file through
    StreamEncoder on `device` (default: local_device()); a FLAC or Ogg
    input decodes there too.  Returns
    (out_path, compressed_size) for the files THIS process wrote."""
    device = local_device(device)
    host_id = _process_index() if host_id is None else host_id
    num_hosts = _process_count() if num_hosts is None else num_hosts
    os.makedirs(out_dir, exist_ok=True)
    results = []
    for path in host_file_shard(paths, host_id, num_hosts):
        with open(path, "rb") as f:
            info = container.sniff_and_read(f.read(), device=device)
        file_cfg = EncoderConfig(
            **{**cfg.__dict__, "sample_rate": info.sample_rate,
               "channels": info.channels,
               "bits_per_sample": info.bits_per_sample}).resolve()
        base = os.path.splitext(os.path.basename(path))[0] + ".flac"
        out_path = os.path.join(out_dir, base)
        with open(out_path, "wb") as f, StreamEncoder(
                f, file_cfg, batch_frames=batch_frames, verify=verify,
                device=device) as enc:
            enc.process(info.samples)
            enc.finish()
        results.append((out_path, os.path.getsize(out_path)))
    return results


def _rows_to_blob(words: np.ndarray, lens: np.ndarray) -> bytes:
    """[B, W] uint32 frame words and [B] byte lengths -> the frames'
    bytes, in order."""
    wbytes = words.astype(">u4").view(np.uint8).reshape(words.shape[0], -1)
    return native.gather_frames(wbytes, lens.astype(np.int64))


def encode_file_ranges(blocks: np.ndarray, cfg: EncoderConfig,
                       *, host_id: int | None = None,
                       num_hosts: int | None = None, mesh=None,
                       device=None) -> tuple[bytes, np.ndarray, int]:
    """Frame-range sharding of ONE file across processes (frame tier).

    blocks: [B, C, N], the same array in every process (or at least this
    process's range of it); process h encodes the contiguous range
    [h*ceil(B/H), ...) with absolute frame numbers over `mesh` (default:
    this process's device, `device` or local_device()), so the blobs
    concatenated in process order are the single-process stream's frames
    byte for byte.

    Returns (my_bytes, all_lengths [H] int64, my_offset), my_offset being
    this process's byte offset in the spliced stream; all_lengths is
    gathered over the process group, the only traffic between processes.
    With num_hosts given and other than the group's size, one process
    simulates them all: it encodes the whole batch once and returns host
    host_id's share.
    """
    host_id = _process_index() if host_id is None else host_id
    num_hosts = _process_count() if num_hosts is None else num_hosts
    B = blocks.shape[0]
    per = -(-B // num_hosts)
    lo, hi = host_id * per, min((host_id + 1) * per, B)

    if num_hosts > 1 and _process_count() != num_hosts:
        # single-process simulation (host_id/num_hosts injected): a real
        # gather would see only ONE process and mis-splice.  ONE sharded
        # encode of the full batch yields every frame's bytes; my blob is
        # my row range and the per-host lengths are row-range sums.  Frame
        # bytes do not depend on the batch they were encoded in
        # (tests/test_torch_shard.py), so these equal what the real
        # processes would produce.
        words, lens = encode_blocks_dp(blocks, 0, cfg,
                                       mesh or (local_device(device),))
        lens64 = lens.astype(np.int64)
        my_blob = _rows_to_blob(words[lo:hi], lens64[lo:hi]) \
            if lo < hi else b""
        all_lens = np.array(
            [int(lens64[h * per:min((h + 1) * per, B)].sum())
             for h in range(num_hosts)], np.int64)
        return my_blob, all_lens, int(all_lens[:host_id].sum())

    if lo >= hi:
        my_blob = b""
    else:
        words, lens = encode_blocks_dp(blocks[lo:hi], lo, cfg,
                                       mesh or (local_device(device),))
        my_blob = _rows_to_blob(words, lens)
    if num_hosts > 1:
        mine = torch.tensor([len(my_blob)], dtype=torch.int64)
        gathered = [torch.zeros_like(mine) for _ in range(num_hosts)]
        dist.all_gather(gathered, mine)
        all_lens = torch.cat(gathered).numpy()
    else:
        all_lens = np.array([len(my_blob)], np.int64)
    return my_blob, all_lens, int(all_lens[:host_id].sum())


def main(argv=None, *, device=None) -> int:
    """Corpus runner:
    python -m flac_tpu_torch.parallel.multihost -5 -o OUTDIR a.wav ...

    Each process encodes its round-robin share of the files on its GPU
    (`device` when called in-process; pass "cpu" to run on the CPU)."""
    import argparse

    p = argparse.ArgumentParser(prog="flac-tpu-corpus")
    for lvl in range(9):
        p.add_argument(f"-{lvl}", dest="preset", action="store_const",
                       const=lvl)
    p.set_defaults(preset=5)
    p.add_argument("-o", "--out-dir", required=True)
    p.add_argument("-V", "--verify", action="store_true")
    p.add_argument("--batch-frames", type=int, default=64)
    p.add_argument("files", nargs="+")
    args = p.parse_args(argv)

    device = local_device(device)
    owned = not dist.is_initialized()
    host, nhosts = init_distributed()
    try:
        cfg = EncoderConfig.from_preset(args.preset)
        results = encode_corpus(args.files, cfg, args.out_dir,
                                batch_frames=args.batch_frames,
                                verify=args.verify, device=device)
        for path, size in results:
            print(f"[host {host}/{nhosts}] {path}: {size} bytes")
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
