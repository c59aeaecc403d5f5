"""The plain reference that decides `correct`: a FLAC stream checked
against the PCM it was made from, in plain PyTorch.

It imports nothing of the program under test.  It reads the container
(the fLaC mark, the metadata chain, STREAMINFO), finds every frame, checks
each frame header and its CRC-8, parses every subframe and every Rice
partition, checks the byte padding and each frame's CRC-16, recomputes the
MD5 from the input, and holds every decoded sample to the input.

A decoder rebuilds a FIXED or LPC subframe by the recursion
x[n] = r[n] + (sum_j c_j x[n-1-j] >> shift) from its warm-up samples.  Given
the warm-up and the coefficients, that recursion maps the residuals to the
samples one to one, so the decoded samples equal the input exactly when
the warm-up equals the input and every coded residual equals the residual
of the input, r[n] = e[n] - (sum_j c_j e[n-1-j] >> shift).  The check reads
the stream that way: it computes each subframe's residuals from the input
(whole rows at a time, no recursion) and requires the Rice code of each
at the place the stream's own partition parameters put it.  Every bit of a
frame is read, and a frame that a sequential decoder would read otherwise
fails here too.

Frames are found by their sync code and header CRC-8, frame i as the
first candidate numbered i; each frame must then end (padding, CRC-16)
exactly where frame i + 1 begins, and the last where the stream ends, so
the frames found are the ones a sequential decoder would read.

`check_stream` returns the counts that `correct` compares (each must be
0) and the parse that the work arithmetic reads (work.py).
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

BLOCKSIZE_CODES = {192: 1, 576: 2, 1152: 3, 2304: 4, 4608: 5, 256: 8,
                   512: 9, 1024: 10, 2048: 11, 4096: 12, 8192: 13,
                   16384: 14, 32768: 15}
SAMPLE_RATE_CODES = {88200: 1, 176400: 2, 192000: 3, 8000: 4, 16000: 5,
                     22050: 6, 24000: 7, 32000: 8, 44100: 9, 48000: 10,
                     96000: 11}
BPS_CODES = {8: 1, 12: 2, 16: 4, 20: 5, 24: 6, 32: 7}
WINDOW_BITS = 49          # bits a 7-byte read holds after any bit offset


def _crc8_table() -> np.ndarray:
    t = np.zeros(256, np.int64)
    for v in range(256):
        c = v
        for _ in range(8):
            c = ((c << 1) ^ 0x07) & 0xFF if c & 0x80 else (c << 1) & 0xFF
        t[v] = c
    return t


def _crc16_table() -> np.ndarray:
    t = np.zeros(256, np.int64)
    for v in range(256):
        c = v << 8
        for _ in range(8):
            c = ((c << 1) ^ 0x8005) & 0xFFFF if c & 0x8000 else \
                (c << 1) & 0xFFFF
        t[v] = c
    return t


CRC8 = _crc8_table()
CRC16 = _crc16_table()
_CRC16_BY_DISTANCE: list = [None]


def crc16_by_distance(D: int) -> np.ndarray:
    """[D, 256]: the CRC-16 (init 0) of byte v followed by d zero bytes.
    The CRC is linear, so a message's CRC is the XOR of these over its
    bytes, d the bytes after each."""
    have = _CRC16_BY_DISTANCE[0]
    if have is not None and have.shape[0] >= D:
        return have
    t = np.zeros((max(D, 1), 256), np.int64)
    c = CRC16.copy()
    for d in range(t.shape[0]):
        t[d] = c
        c = ((c << 8) & 0xFFFF) ^ CRC16[c >> 8]
    _CRC16_BY_DISTANCE[0] = t
    return t


def md5_of_pcm(pcm: np.ndarray, bps: int) -> bytes:
    """The STREAMINFO MD5 of [C, n] samples: interleaved little-endian
    signed samples of (bps + 7) // 8 bytes."""
    nb = (bps + 7) // 8
    inter = np.ascontiguousarray(pcm.T.astype("<i4"))
    if nb < 4:
        inter = inter.view(np.uint8).reshape(pcm.shape[1], pcm.shape[0],
                                             4)[:, :, :nb]
    return hashlib.md5(np.ascontiguousarray(inter).tobytes()).digest()


class Bits:
    """A byte string on a device, read at any bit position."""

    def __init__(self, data: bytes, device):
        raw = torch.frombuffer(bytearray(data) + bytes(16), dtype=torch.uint8)
        b = raw.to(device).to(torch.int64)
        self.b = b
        self.nbytes = len(data)
        # the 56 bits from each byte on
        n = len(data) + 9
        self.w = torch.zeros(n, dtype=torch.int64, device=b.device)
        for i in range(7):
            self.w = (self.w << 8) | b[i:i + n]

    def read(self, pos: torch.Tensor, n) -> torch.Tensor:
        """The unsigned n-bit field at bit `pos` (n <= 49, a tensor or an
        int; n may be 0)."""
        w = self.w[(pos >> 3).clamp(0, self.nbytes + 8)]
        n = torch.as_tensor(n, dtype=torch.int64, device=pos.device)
        return (w >> (56 - (pos & 7) - n)) & ((torch.ones_like(n) << n) - 1)

    def signed(self, pos, n) -> torch.Tensor:
        v = self.read(pos, n)
        n = torch.as_tensor(n, dtype=torch.int64, device=pos.device)
        top = (torch.ones_like(n) << (n - 1).clamp(min=0))
        return torch.where((n > 0) & (v >= top), v - (top << 1), v)


def _metadata(data: bytes) -> tuple[dict, int, int]:
    """(STREAMINFO fields, offset of the first frame, metadata faults)."""
    bad = 0
    if data[:4] != b"fLaC":
        return {}, 4, 1
    pos, info, first = 4, {}, True
    while pos + 4 <= len(data):
        hdr = int.from_bytes(data[pos:pos + 4], "big")
        last, typ, length = hdr >> 31, (hdr >> 24) & 0x7F, hdr & 0xFFFFFF
        body = data[pos + 4:pos + 4 + length]
        if first:
            if typ != 0 or length != 34:
                bad += 1
            else:
                v = int.from_bytes(body[10:18], "big")
                info = {"min_blocksize": int.from_bytes(body[0:2], "big"),
                        "max_blocksize": int.from_bytes(body[2:4], "big"),
                        "min_framesize": int.from_bytes(body[4:7], "big"),
                        "max_framesize": int.from_bytes(body[7:10], "big"),
                        "sample_rate": v >> 44,
                        "channels": ((v >> 41) & 7) + 1,
                        "bits_per_sample": ((v >> 36) & 31) + 1,
                        "total_samples": v & ((1 << 36) - 1),
                        "md5": body[18:34]}
        first = False
        pos += 4 + length
        if last:
            break
    return info, pos, bad


def _utf8_number(bits: Bits, p: torch.Tensor):
    """Frame numbers at byte positions p (UTF-8 coded): (number, byte
    count, valid)."""
    b0 = bits.b[p]
    ones = torch.zeros_like(b0)
    for k in range(8):
        ones = torch.where((ones == k) & (((b0 >> (7 - k)) & 1) == 1),
                           ones + 1, ones)
    count = torch.where(ones == 0, 1, ones)
    valid = (ones != 1) & (ones <= 7)
    lead_bits = torch.where(ones == 0, 7, (7 - ones).clamp(min=0))
    num = b0 & ((torch.ones_like(b0) << lead_bits) - 1)
    for i in range(1, 7):
        bi = bits.b[p + i]
        more = count > i
        valid &= ~more | ((bi >> 6) == 2)
        num = torch.where(more, (num << 6) | (bi & 0x3F), num)
    return num, count, valid


def _candidates(bits: Bits, start: int, nframes: int, N: int, tail: int,
                rate: int, bps: int, C: int):
    """Every place after `start` where a frame header with a good CRC-8
    and a frame number below `nframes` begins: (byte offsets, frame
    numbers, header lengths, channel assignments, header faults: a block
    size, rate, sample size or channel code this stream cannot have)."""
    dev = bits.b.device
    b = bits.b
    body = b[start:bits.nbytes]
    cand = torch.nonzero((body[:-1] == 0xFF) & (body[1:] == 0xF8)).flatten() \
        + start
    b2, b3 = b[cand + 2], b[cand + 3]
    num, ulen, ok = _utf8_number(bits, cand + 4)
    bs_code, sr_code = b2 >> 4, b2 & 15
    ch_code, ss_code = b3 >> 4, (b3 >> 1) & 7
    at = cand + 4 + ulen
    bs = torch.zeros_like(cand)
    bs = torch.where(bs_code == 6, b[at] + 1, bs)
    bs = torch.where(bs_code == 7, (b[at] << 8 | b[at + 1]) + 1, bs)
    for size, code in BLOCKSIZE_CODES.items():
        bs = torch.where(bs_code == code, size, bs)
    at = at + torch.where(bs_code == 6, 1, 0) + torch.where(bs_code == 7, 2, 0)
    at = at + torch.where(sr_code == 12, 1, 0) + torch.where(
        (sr_code == 13) | (sr_code == 14), 2, 0)
    hlen = at - cand + 1                      # with the CRC-8 byte
    crc = torch.zeros_like(cand)
    table = torch.as_tensor(CRC8, device=dev)
    for i in range(int(hlen.max()) if cand.numel() else 0):
        crc = torch.where(i < hlen - 1, table[crc ^ b[cand + i]], crc)
    ok &= (crc == b[at]) & ((b3 & 1) == 0) & (num < nframes)
    cand, num, hlen, bs = cand[ok], num[ok], hlen[ok], bs[ok]
    sr_code, ss_code, ch = sr_code[ok], ss_code[ok], ch_code[ok]
    want_bs = torch.where(num == nframes - 1, tail, N)
    fault = bs != want_bs
    fault |= (sr_code != SAMPLE_RATE_CODES.get(rate, 0)) & (sr_code != 0)
    fault |= (ss_code != BPS_CODES.get(bps, 0)) & (ss_code != 0)
    fault |= ~((ch == C - 1) | ((C == 2) & (ch >= 8) & (ch <= 10)))
    return cand, num, hlen, ch, fault


def _fixed_residual(e: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """[F, N] residuals of the fixed predictor of each row's order."""
    d = [e]
    for _ in range(4):
        prev = d[-1]
        d.append(torch.cat([prev[:, :1], prev[:, 1:] - prev[:, :-1]], 1))
    r = d[0]
    for k in range(1, 5):
        r = torch.where((order == k)[:, None], d[k], r)
    return r


def _lpc_residual(e, coefs, order, shift):
    """[F, N] residuals e[n] - (sum_j c_j e[n-1-j] >> shift) (exact int64;
    rows past n < order are not coded and come out as anything)."""
    F, N = e.shape
    pred = torch.zeros_like(e)
    for j in range(int(order.max()) if order.numel() else 0):
        c = torch.where(j < order, coefs[:, j], 0)[:, None]
        pred[:, j + 1:] += c * e[:, :N - j - 1]
    return e - (pred >> shift[:, None])


def _read_values(bits, base, width, count, Nmax):
    """[F, Nmax] signed fields of `width` bits at base + n * width, n <
    count (zero past it)."""
    n = torch.arange(Nmax, device=base.device)
    pos = base[:, None] + n[None, :] * width[:, None]
    v = bits.signed(pos, width[:, None].expand_as(pos))
    return torch.where(n[None, :] < count[:, None], v, 0)


def _check_rice(bits, start, r, N_f, order, po, method, live):
    """Read the residual section of each row at bit `start` against the
    residuals `r` [F, N] that the input gives.  Rows are taken in groups
    of one block size and partition order, a partition at a time (each
    partition's place follows from the previous one's codes).  Returns
    (end bit positions [F], samples that do not match [F], rows whose
    section is malformed [F])."""
    dev = r.device
    pb = torch.where(method == 0, 4, 5)
    esc = (torch.ones_like(pb) << pb) - 1
    parts = torch.ones_like(po) << po
    m = N_f >> po
    bad_rows = live & ((method > 1) | (N_f % parts != 0) | (m < order)
                       | ((po > 0) & (m <= order)))
    live = live & ~bad_rows
    end = start.clone()
    bad = torch.zeros_like(start)
    key = N_f * 16 + po
    for kv in torch.unique(key[live]).tolist():
        idx = torch.nonzero(live & (key == kv)).flatten()
        Nk, P = kv // 16, 1 << (kv % 16)
        mk = Nk // P
        zg = r[idx, :Nk]
        zg = ((zg << 1) ^ (zg >> 63)).reshape(len(idx), P, mk)  # zigzag
        og = order[idx]
        j = torch.arange(mk, device=dev)
        coded = torch.ones((len(idx), P, mk), dtype=torch.bool, device=dev)
        coded[:, 0, :] = j[None, :] >= og[:, None]
        pbg, escg = pb[idx], esc[idx]
        pos = start[idx] + 6
        ks, raws, escs, datas = [], [], [], []
        for p in range(P):
            k = bits.read(pos, pbg)
            is_esc = k == escg
            raw = bits.read(pos + pbg, 5)
            data = pos + pbg + torch.where(is_esc, 5, 0)
            length = torch.where(is_esc[:, None], raw[:, None],
                                 (zg[:, p] >> k[:, None]) + 1 + k[:, None])
            length = torch.where(coded[:, p], length, 0)
            pos = data + length.sum(1)
            ks.append(k)
            raws.append(raw)
            escs.append(is_esc)
            datas.append(data)
        K = torch.stack(ks, 1)[..., None]
        RAW = torch.stack(raws, 1)[..., None]
        ESC = torch.stack(escs, 1)[..., None]
        q = zg >> K
        length = torch.where(coded, torch.where(ESC, RAW, q + 1 + K), 0)
        off = torch.stack(datas, 1)[..., None] + torch.cumsum(length, -1) \
            - length
        wrong = torch.zeros_like(coded)
        if bool(ESC.any()):
            # escaped partitions: raw signed fields
            val = (zg >> 1) ^ -(zg & 1)
            wrong |= coded & ESC & (bits.signed(off, torch.where(
                ESC, RAW, 0).expand_as(off)) != val)
        # Rice codes: q zeros, a one, the k low bits
        rice = coded & ~ESC
        L = q + 1 + K
        short = rice & (L <= WINDOW_BITS)
        mask = (torch.ones_like(K) << K) - 1
        want = (mask + 1) | (zg & mask)
        wrong |= short & (bits.read(off, torch.where(short, L, 0)) != want)
        long_ = rice & ~short
        if bool(long_.any()):
            w = torch.nonzero(long_, as_tuple=True)
            o, qq = off[w], q[w]
            kk = K.expand_as(q)[w]
            zz = zg[w]
            lw = torch.zeros_like(o, dtype=torch.bool)
            done = torch.zeros_like(o)
            while bool((done < qq).any()):
                step = (qq - done).clamp(max=48)
                lw |= (step > 0) & (bits.read(o + done, step) != 0)
                done = done + step
            km = (torch.ones_like(kk) << kk) - 1
            lw |= bits.read(o + qq, 1 + kk) != ((km + 1) | (zz & km))
            wrong[w] = wrong[w] | lw
        end[idx] = pos
        bad[idx] = wrong.sum((1, 2))
    return end, bad, bad_rows


def _check_channel(bits, pos, e_full, N_f, ebps0, live):
    """Read one channel's subframe of every frame at bit `pos` against
    the channel signal `e_full` [F, N] the input gives.  Returns (end bit
    positions, mismatched samples [F], live [F], the parse's rows)."""
    dev = pos.device
    F, N = e_full.shape
    n_idx = torch.arange(N, device=dev)
    in_frame = n_idx[None, :] < N_f[:, None]
    h = bits.read(pos, 8)
    typ = (h >> 1) & 63
    wflag = h & 1
    u = bits.read(pos + 8, 32)
    lz = 32 - torch.where(u > 0, torch.floor(torch.log2(
        u.clamp(min=1).double())).long() + 1, 0)
    wasted = torch.where(wflag == 1, lz + 1, 0)
    ebps = ebps0 - wasted
    is_const, is_verb = typ == 0, typ == 1
    is_fixed, is_lpc = (typ >= 8) & (typ <= 12), typ >= 32
    live = live & ((h >> 7) == 0) & ((wflag == 0) | (u > 0)) & \
        (ebps > 0) & (ebps <= 33) & (is_const | is_verb | is_fixed | is_lpc)
    order = torch.where(is_fixed, typ - 8, torch.where(is_lpc, typ - 31, 0))
    p = pos + 8 + torch.where(wflag == 1, lz + 1, 0)
    width = ebps.clamp(1, 33)
    bad = torch.zeros(F, dtype=torch.int64, device=dev)
    end = p.clone()
    # a wasted bit must be a zero bit of the signal
    low = e_full & ((torch.ones_like(wasted) << wasted) - 1)[:, None]
    bad += torch.where(live, (in_frame & (low != 0)).sum(1), 0)
    e = e_full >> wasted[:, None]
    idx = torch.nonzero(live & is_const).flatten()
    if len(idx):
        v = bits.signed(p[idx], width[idx])
        bad[idx] += (in_frame[idx] & (e[idx] != v[:, None])).sum(1)
        end[idx] = p[idx] + width[idx]
    idx = torch.nonzero(live & is_verb).flatten()
    if len(idx):
        v = _read_values(bits, p[idx], width[idx], N_f[idx], N)
        bad[idx] += (in_frame[idx] & (e[idx] != v)).sum(1)
        end[idx] = p[idx] + N_f[idx] * width[idx]
    res = live & (is_fixed | is_lpc)
    idx = torch.nonzero(res).flatten()
    method = torch.zeros_like(p)
    po = torch.zeros_like(p)
    if len(idx):
        pi, oi, wi, ei = p[idx], order[idx], width[idx], e[idx]
        warm = _read_values(bits, pi, wi, oi, 32)
        wmask = torch.arange(32, device=dev)[None, :] < oi[:, None]
        bad[idx] += (wmask & (warm != ei[:, :32])).sum(1)
        p2 = pi + oi * wi
        lpc = is_lpc[idx]
        prec = bits.read(p2, 4) + 1
        shift = bits.signed(p2 + 4, 5)
        ok = ~lpc | ((prec < 16) & (shift >= 0))
        coefs = _read_values(bits, p2 + 9, torch.where(lpc, prec, 1),
                             torch.where(lpc, oi, 0), 32)
        p3 = torch.where(lpc, p2 + 9 + oi * prec, p2)
        r = _fixed_residual(ei, torch.where(lpc, 0, oi))
        li = torch.nonzero(lpc).flatten()
        if len(li):
            r[li] = _lpc_residual(ei[li], coefs[li], oi[li],
                                  shift[li].clamp(min=0))
        method[idx] = bits.read(p3, 2)
        po[idx] = bits.read(p3 + 2, 4)
        end_r, bad_r, bad_rows = _check_rice(
            bits, p3, r, N_f[idx], oi, po[idx], method[idx], ok)
        bad[idx] += bad_r
        end[idx] = end_r
        live[idx] = live[idx] & ok & ~bad_rows
    rows = {"type": torch.where(is_const, 0, torch.where(
                is_verb, 1, torch.where(is_fixed, 2, 3))).cpu().numpy(),
            "po": po.cpu().numpy(), "has_res": res.cpu().numpy()}
    return end, bad, live, rows


def check_stream(stream: bytes, pcm: np.ndarray, *, bps: int, rate: int,
                 blocksize: int, device="cpu", md5: bytes | None = None
                 ) -> dict:
    """Hold a FLAC stream to the [C, n] int32 PCM it encodes.

    Every frame header candidate is read as a frame of the samples its
    number names; then the frames are chained as a decoder reads them:
    frame 0 where the metadata ends, frame f + 1 where frame f ends, the
    stream's end after the last.

    Returns {"frames", "bad_frames", "bad_samples", "md5_bad",
    "info_bad", "parse"}: bad_* count frames that are missing from the
    chain or whose header, CRC, padding or length is wrong, samples that
    do not decode to the input, an MD5 that is not the input's (0 or 1),
    and STREAMINFO fields that are wrong.  `md5`: the input's MD5 where
    the caller has computed it (md5_of_pcm).  "parse" holds per-frame rows
    of the chained frames (byte lengths; per channel the subframe type
    (0 constant, 1 verbatim, 2 fixed, 3 LPC), partition order, whether it
    carries residuals) for the work arithmetic."""
    C, n = pcm.shape
    N = blocksize
    nframes = -(-n // N)
    tail = n - (nframes - 1) * N
    info, first, meta_bad = _metadata(stream)
    out = {"frames": nframes, "bad_frames": 0, "bad_samples": 0,
           "md5_bad": int(info.get("md5") != (md5 or md5_of_pcm(pcm, bps))),
           "info_bad": meta_bad}
    want = {"min_blocksize": N, "max_blocksize": N, "sample_rate": rate,
            "channels": C, "bits_per_sample": bps, "total_samples": n}
    out["info_bad"] += sum(info.get(k) != v for k, v in want.items())
    bits = Bits(stream, device)
    dev = bits.b.device
    starts, num, hlen, ch, fault = _candidates(bits, first, nframes, N, tail,
                                               rate, bps, C)
    K = len(starts)
    N_f = torch.where(num == nframes - 1, tail, N)
    x = torch.from_numpy(np.ascontiguousarray(pcm, np.int32)).to(dev)
    x = torch.nn.functional.pad(x.to(torch.int64), (0, nframes * N - n))
    x = x.reshape(C, nframes, N)[:, num]          # [C, K, N]
    # the channel signals each candidate codes, by its channel assignment
    sig = [x[c] for c in range(C)]
    side = [torch.zeros_like(ch) for _ in range(C)]
    if C == 2:
        L, R = x[0], x[1]
        a = ch[:, None]
        sig = [torch.where(a == 9, L - R,
                           torch.where(a == 10, (L + R) >> 1, L)),
               torch.where((a == 8) | (a == 10), L - R, R)]
        side = [(ch == 9).long(), ((ch == 8) | (ch == 10)).long()]
    live = ~fault
    pos = (starts + hlen) * 8
    bad_samples = torch.zeros(K, dtype=torch.int64, device=dev)
    rows = []
    for c in range(C):
        pos, bad_c, live, r = _check_channel(bits, pos, sig[c], N_f,
                                             bps + side[c], live)
        bad_samples += bad_c
        rows.append(r)
    # byte padding of zeros, then the CRC-16
    pad = (8 - pos % 8) % 8
    live &= bits.read(pos, pad) == 0
    frame_end = (pos + pad) // 8 + 2
    byte_len = frame_end - starts
    max_len = N * C * (bps + 1) // 8 + 64
    live &= (frame_end <= bits.nbytes) & (byte_len <= max_len)
    # CRC-16 over each frame, its own CRC included, must be 0
    if bool(live.any()):
        fl = torch.where(live, byte_len, 0)
        table = torch.as_tensor(crc16_by_distance(int(fl.max())),
                                device=dev)
        frame_of = torch.repeat_interleave(torch.arange(K, device=dev), fl)
        first_byte = torch.cumsum(fl, 0) - fl
        within = torch.arange(int(fl.sum()), device=dev) \
            - first_byte[frame_of]
        byte = bits.b[starts[frame_of] + within]
        contrib = table[fl[frame_of] - 1 - within, byte]
        crc = torch.zeros(K, dtype=torch.int64, device=dev)
        for bit in range(16):
            plane = torch.zeros(K, dtype=torch.int64, device=dev)
            plane.index_add_(0, frame_of, (contrib >> bit) & 1)
            crc |= (plane & 1) << bit
        live &= crc == 0
    # the chain a decoder reads
    at = dict(zip(starts.tolist(), range(K)))
    num_l, end_l = num.tolist(), frame_end.tolist()
    chain, p = [], first
    for f in range(nframes):
        k = at.get(p)
        if k is None or num_l[k] != f:
            break
        chain.append(k)
        p = end_l[k]
    idx = torch.tensor(chain, dtype=torch.int64, device=dev)
    out["bad_frames"] = (nframes - len(chain)) + int((~live[idx]).sum()) \
        + int(len(chain) == nframes and p != bits.nbytes)
    out["bad_samples"] = int(bad_samples[idx].sum())
    lens = byte_len[idx].cpu().numpy()
    if len(lens):
        out["info_bad"] += int(info.get("min_framesize") != int(lens.min()))
        out["info_bad"] += int(info.get("max_framesize") != int(lens.max()))
    ci = np.asarray(chain, np.int64)
    out["parse"] = {"byte_len": lens,
                    "channels": [{k: v[ci] for k, v in r.items()}
                                 for r in rows]}
    return out
