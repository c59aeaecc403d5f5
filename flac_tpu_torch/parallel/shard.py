"""Data-parallel frame sharding over devices.

Port of flac_tpu/parallel/shard.py.  Frames are independent by format
design, so a batch splits along its frame axis into one contiguous shard a
mesh entry, and each shard is encoded (or, in decode, restored by K3) on
its entry's device with its absolute frame numbers.  No collective runs:
every frame's bytes stay on their device until the host reads the shards
back in order.

A mesh is a tuple of torch.device, the counterpart of the reference's 1-D
jax Mesh.  An entry may name a device that another entry names too: each
entry is one shard, so `("cpu",) * 8` or `("cuda:0",) * 4` splits a batch
eight or four ways on one device.  That is how the CPU tests, and a
machine with one GPU, run a split over more than one entry.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..config import EncoderConfig
from ..decoder_fast import _group_arrays, restore_and_undo, wide_frames
from ..device import resolve_device
from ..encoder import encode_batch
from ..ops import restore_cuda
from ..ref_decoder import DecodedStream, FlacDecodeError


def data_mesh(devices=None) -> tuple[torch.device, ...]:
    """Every CUDA device, one entry each (raises when there is none), or
    one entry for each of `devices` (an entry may repeat a device)."""
    if devices is None:
        resolve_device("cuda")
        return tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    mesh = tuple(resolve_device(d) for d in devices)
    if not mesh:
        raise ValueError("data_mesh: no devices")
    return mesh


def encode_batch_sharded(pcm, first_frame_number: int, cfg: EncoderConfig,
                         blocksize: int, mesh) -> list:
    """encode_batch with the frame axis split over the mesh.

    pcm: [B, C, N] integer array or tensor, B divisible by len(mesh).
    Shard i, frames [i*B/len(mesh), (i+1)*B/len(mesh)), is encoded on
    mesh[i] with those frame numbers; every shard is launched before any
    result is read back: each shard's encode is its device's compiled
    program for the shard's shape (encoder.encode_batch), and a host batch
    is pinned first, so no shard's upload waits for the encodes queued
    before it.  Returns the shards' PackedFrames in order, each on its
    device."""
    n = len(mesh)
    B = pcm.shape[0]
    if B % n:
        raise ValueError(f"encode_batch_sharded: {B} frames do not split "
                         f"into {n} equal shards")
    pcm = torch.as_tensor(pcm).to(torch.int32)
    if pcm.device.type == "cpu" and any(torch.device(d).type == "cuda"
                                        for d in mesh):
        pcm = pcm.pin_memory()
    per = B // n
    return [encode_batch(pcm[i * per:(i + 1) * per].to(dev,
                                                        non_blocking=True),
                         first_frame_number + i * per, cfg, blocksize)
            for i, dev in enumerate(mesh)]


def _host_words(words: torch.Tensor) -> np.ndarray:
    """[B, W] int64 device words holding uint32 -> [B, W] np.uint32."""
    return words.to(torch.int32).cpu().numpy().view(np.uint32)


def encode_blocks_dp(blocks: np.ndarray, first_frame_number: int,
                     cfg: EncoderConfig, mesh=None):
    """Pad the batch to a multiple of the mesh with repeats of its last
    block, encode it sharded, and return (words [B, W] np.uint32, byte_len
    [B] np.int32) for the real B.  Quad-layout misfits are re-encoded with
    the safe layout on their shard's device."""
    mesh = mesh or data_mesh()
    n = len(mesh)
    B = blocks.shape[0]
    Bp = -(-B // n) * n
    if Bp != B:
        blocks = np.concatenate(
            [blocks, np.repeat(blocks[-1:], Bp - B, axis=0)], axis=0)
    N = blocks.shape[-1]
    shards = encode_batch_sharded(blocks, first_frame_number, cfg, N, mesh)
    words = np.concatenate([_host_words(pf.words) for pf in shards])[:B]
    lens = np.concatenate([pf.byte_len.cpu().numpy()
                           for pf in shards])[:B].astype(np.int32)
    ok = np.concatenate([pf.ok.cpu().numpy() for pf in shards])[:B]
    per = Bp // n
    for i in np.nonzero(~ok)[0]:
        i = int(i)
        pf = encode_batch(
            torch.from_numpy(np.ascontiguousarray(blocks[i:i + 1])).to(
                mesh[i // per], torch.int32),
            first_frame_number + i, cfg, N, layout="safe")
        w = _host_words(pf.words)[0]
        if w.shape[0] > words.shape[1]:
            words = np.pad(words, ((0, 0), (0, w.shape[0] - words.shape[1])))
        words[i, :w.shape[0]] = w
        lens[i] = int(pf.byte_len[0])
    return words, lens


def decode_frames_dp(data, st: DecodedStream, frames: list, mesh=None,
                     channels: int | None = None) -> np.ndarray:
    """Sharded batched decode of a list of frames that share blocksize and
    channels: the native full parse on the host, then K3 on each mesh
    entry for a contiguous group of whole frames (the groups differ in
    size by at most one frame; an empty group launches nothing).  Frames
    with a subframe of 32 bits or more restore in int64
    (decoder_fast.wide_frames).  Raises FlacDecodeError on a frame that
    fails to parse, its CRC-16 or the stream's sample range.  Returns
    [C, F*N] int32 PCM."""
    mesh = mesh or data_mesh()
    blocksize = frames[0]["blocksize"]
    channels = channels or frames[0]["channels"]
    F = len(frames)
    offsets, start_bits, sizes, asg, ch_bps = _group_arrays(
        frames, range(F), channels)
    pg = native.parse_frames(
        data if isinstance(data, np.ndarray)
        else np.frombuffer(data, np.uint8),
        offsets, start_bits, sizes, ch_bps, blocksize,
        wide=bool(wide_frames(ch_bps).any()))
    bad = ~np.isin(pg.status, (native.FT_OK, native.FT_EXTENT_MISMATCH))
    if bad.any():
        raise FlacDecodeError("frame CRC16 mismatch or parse failure at "
                              f"frame {frames[int(np.argmax(bad))]['number']}")
    mo = restore_cuda.kernel_order(int(pg.order.max(initial=0)))
    qlp = np.ascontiguousarray(pg.qlp[:, :mo])
    out = []
    for dev, idx in zip(mesh, np.array_split(np.arange(F), len(mesh))):
        if not len(idx):
            continue
        lo, hi = int(idx[0]), int(idx[-1]) + 1
        s = slice(lo * channels, hi * channels)
        out.append(restore_and_undo(
            *(torch.from_numpy(a).to(dev) for a in (
                pg.res[s], pg.order[s], pg.shift[s], qlp[s], pg.wasted[s],
                asg[lo:hi])),
            blocksize=blocksize, channels=channels, max_order=mo,
            wide=pg.wide, out16=False, bps=st.bits_per_sample or 0))
    sig = np.concatenate([pcm.cpu().numpy() for pcm, _ in out])
    oor = np.concatenate([flags.cpu().numpy() for _, flags in out])
    if oor.any():
        raise FlacDecodeError("decoded sample out of bps range at frame "
                              f"{frames[int(np.argmax(oor))]['number']}")
    return sig.astype(np.int32).transpose(1, 0, 2).reshape(
        channels, F * blocksize)
