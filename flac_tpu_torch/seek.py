"""Random access into FLAC streams: seek + ranged decode.

Port of flac_tpu/seek.py.  The batched counterpart of
FLAC__stream_decoder_seek_absolute (libFLAC's
src/libFLAC/stream_decoder.c:1282, algorithm at :3647-3900).  The reference runs an interpolated binary search over the
file, decoding one trial frame per probe.  Here the expensive part — frame
decode — is batched on device, and the search is a host-side header scan:

  1. bound the byte window from STREAMINFO + SEEKTABLE points
     (stream_decoder.c:3693-3761);
  2. linearly-interpolate a start guess inside the window and scan
     forward for verified frame headers (sync + CRC-8, the same
     validation as frame_sync_ stream_decoder.c:2321) until the frame
     containing the target sample is found — the scan is a vectorized
     numpy pass, orders of magnitude cheaper than trial decodes;
  3. decode the covering frames in one device batch and slice.

A FlacReader built once serves any number of random reads; the frame
index is extended lazily and cached.  Reads decode on the device through
the "device" engine (kernels K2 and K3) or, with use_device=False, through
the native host engine; there is no pure-Python fallback, as the native
runtime raises when it cannot build.
"""

from __future__ import annotations

import numpy as np

from . import format as fmt
from .decoder import decode_frame_list, decode_frames_selected, \
    parse_frame_header
from .device import resolve_device
from .metadata import SeekTableBlock
from .ref_decoder import FlacDecodeError, parse_metadata


class FlacReader:
    """Random-access reader over an in-memory FLAC stream.

    use_device=True decodes on `device` (None means "cuda" and raises
    without a GPU; pass "cpu" to run the device engine's plain versions on
    the CPU); use_device=False decodes with the native host engine."""

    def __init__(self, data: bytes, *, use_device: bool = True,
                 device=None):
        if data[:4] != fmt.STREAM_SYNC_STRING:
            raise FlacDecodeError("missing fLaC marker")
        self.data = data
        self.st, self.first_frame_offset = parse_metadata(data, 4)
        self.use_device = use_device
        self.device = resolve_device(device) if use_device else None
        self._frames: list[dict] = []       # verified headers, stream order
        self._scanned_to = self.first_frame_offset
        self._seektable = None
        for btype, body in self.st.metadata:
            if btype == fmt.METADATA_TYPE_SEEKTABLE:
                self._seektable = SeekTableBlock.parse(body)
        self._pos = 0                        # current sample position

    # -- frame index -------------------------------------------------------

    def _scan_more(self, until_sample: int | None = None,
                   chunk: int = 1 << 22) -> None:
        """Extend the frame index; stop once it covers `until_sample`."""
        data = self.data
        n = len(data)
        while self._scanned_to < n:
            if until_sample is not None and self._frames:
                # a frame starting at/after the target means every frame
                # we need already has its size (next offset known)
                if self._frames[-1]["first_sample"] >= until_sample:
                    break
            stop = min(n, self._scanned_to + chunk)
            arr = np.frombuffer(data, np.uint8, count=stop, offset=0)
            lo = self._scanned_to
            cand = np.where((arr[lo:stop - 1] == 0xFF) &
                            ((arr[lo + 1:stop] & 0xFC) == 0xF8))[0] + lo
            for pos in cand:
                if self._frames and pos < self._frames[-1]["offset"] + 10:
                    continue
                hdr = parse_frame_header(data, int(pos), self.st)
                if hdr is None:
                    continue
                if not self._accept(hdr):
                    continue
                self._frames.append(hdr)
            # overlap by 1 byte: a sync pair straddling the chunk edge
            self._scanned_to = stop - 1 if stop < n else n
        self._fill_sizes()

    def _accept(self, hdr: dict) -> bool:
        """Consecutive-number validation against the previous frame
        (the false-sync filter; format.h:403-406 numbering invariant)."""
        if hdr["variable"]:
            hdr["first_sample"] = hdr["number"]
            if self._frames:
                prev = self._frames[-1]
                return hdr["number"] == prev["first_sample"] + \
                    prev["blocksize"]
            return True
        bs = self.st.max_blocksize or hdr["blocksize"]
        hdr["first_sample"] = hdr["number"] * bs
        if self._frames:
            return hdr["number"] == self._frames[-1]["number"] + 1
        return True

    def _fill_sizes(self) -> None:
        for i, f in enumerate(self._frames):
            if i + 1 < len(self._frames):
                f["size"] = self._frames[i + 1]["offset"] - f["offset"]
            elif self._scanned_to >= len(self.data):
                f["size"] = len(self.data) - f["offset"]
            else:
                f.pop("size", None)

    def _index_covering(self, start: int, n: int) -> list[int]:
        """Frame indices whose samples intersect [start, start+n)."""
        self._scan_more(until_sample=start + n)
        out = []
        for i, f in enumerate(self._frames):
            s0 = f["first_sample"]
            if s0 + f["blocksize"] <= start:
                continue
            if s0 >= start + n:
                break
            if "size" in f:
                out.append(i)
        return out

    # -- public API ---------------------------------------------------------

    @property
    def total_samples(self) -> int:
        return self.st.total_samples

    def seek_absolute(self, sample: int) -> None:
        """Position the reader; mirrors seek_to_absolute_sample_
        (stream_decoder.c:3647): clamp to stream bounds, use the
        SEEKTABLE to skip ahead before scanning."""
        if self.st.total_samples and sample >= self.st.total_samples:
            raise FlacDecodeError("seek past end of stream")
        if not self._frames and self._seektable is not None:
            # jump the scan start to the best seekpoint <= target
            best = None
            for p in self._seektable.points:
                if p.is_placeholder:
                    continue
                if p.sample_number <= sample and (
                        best is None or p.sample_number > best.sample_number):
                    best = p
            if best is not None and best.sample_number > 0:
                self._seed_from_offset(
                    self.first_frame_offset + best.stream_offset,
                    best.sample_number)
        self._pos = sample

    def _seed_from_offset(self, byte_offset: int, first_sample: int) -> None:
        """Trust a seekpoint: start the index mid-stream."""
        hdr = parse_frame_header(self.data, byte_offset, self.st)
        if hdr is None:
            return  # bad seekpoint — fall back to full scan
        hdr["first_sample"] = (
            hdr["number"] if hdr["variable"]
            else hdr["number"] * (self.st.max_blocksize or hdr["blocksize"]))
        if hdr["first_sample"] != first_sample:
            return
        self._frames = [hdr]
        self._scanned_to = byte_offset + 1

    def read(self, n: int) -> np.ndarray:
        """Decode n samples from the current position; advances it."""
        out = self.read_range(self._pos, n)
        self._pos += out.shape[1]
        return out

    def read_range(self, start: int, n: int) -> np.ndarray:
        """Decode exactly the frames covering [start, start+n).

        Returns [C, m] int32 with m <= n (short at end of stream).
        """
        if self.st.total_samples:
            n = max(0, min(n, self.st.total_samples - start))
        idxs = self._index_covering(start, n)
        if not idxs:
            return np.zeros((self.st.channels, 0), np.int32)
        frames = [self._frames[i] for i in idxs]
        sig = self._decode_frames(frames)
        s0 = frames[0]["first_sample"]
        lo = start - s0
        return sig[:, lo:lo + n]

    def _decode_frames(self, frames: list[dict]) -> np.ndarray:
        """Batched decode of an explicit frame list: on the device (K2 and
        K3), or through the native host engine."""
        if self.use_device:
            return decode_frames_selected(self.data, self.st, frames,
                                          device=self.device)
        return np.concatenate(
            decode_frame_list(self.data, self.st, frames, device="cpu",
                              engine="host"), axis=1)
