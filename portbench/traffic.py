"""The general traffic generator: file lengths and PCM from a mix's
parameters (portbench/traffic/<mix>.json) and a seed.

Lengths.  A mix names a length range [seconds_min, seconds_max] and a
count `sizes_per_round`: the lengths of a round are that many quantiles of
the log-uniform distribution over the range, the same for every seed.
Files come in rounds, each round the same lengths in an order drawn from
the seed, so every seed sends the same work in another order.  Each file
ends in a short block, whose size `final_blocks` sets:
- "distinct": file k's last block holds tails[k] samples, where `tails`
  is a fixed permutation of 1 .. blocksize - 2, so no two of the first
  blocksize - 2 files of a run share a final block size, and each final
  block is a shape the program meets once (blocksize - 1 is kept for the
  warm-up);
- "warm": each of a round's lengths ends in a block of its own,
  tails[i] for the i-th length, the same in every round, and the warm-up
  sends each of them twice, so no final block is new in the window.  A
  mix whose window sends more files than there are block sizes takes
  this: its final blocks would else come a second time inside the window,
  where the program captures them.

PCM.  A pool of `pool` buffers, each as long as the longest file, is made
on the device from the seed, by the recipe the mix names under `content`
(make_buffer): sines of fixed frequencies and levels plus Gaussian noise
under a slow envelope, at a share of the format's full scale, with the
sines' and the envelope's phases and the noise drawn (the recipe of
flac_tpu_torch.signals.make_test_signal); optionally `bursts`, decaying
noise bursts (transients) at a fixed rate, and `pauses`, stretches where
the sines fall silent and only the noise floor stays (speech).  Counts
and levels are fixed and only places and phases are drawn, so every
seed's content costs alike.  File k is a slice of buffer k % pool at an
offset drawn from the seed, so no file repeats back to back.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

WARM_TAIL = 1        # the warm-up files' final block: blocksize - WARM_TAIL


@dataclass(frozen=True)
class File:
    index: int
    samples: int        # per channel
    buffer: int
    offset: int


class Plan:
    """The files of a run in order, made lazily: file(k) for any k."""

    def __init__(self, mix: dict, rate: int, blocksize: int, seed: int):
        self.rate, self.N, self.seed = rate, blocksize, seed
        R = int(mix["sizes_per_round"])
        lo, hi = float(mix["seconds_min"]), float(mix["seconds_max"])
        q = (np.arange(R) + 0.5) / R
        self.sizes = np.round(lo * (hi / lo) ** q * rate).astype(np.int64)
        self.max_samples = int(self.sizes.max()) + blocksize
        # tails: a fixed permutation, not the seed's
        self.tails = np.random.default_rng(0x7A11).permutation(
            np.arange(1, blocksize - WARM_TAIL)) if blocksize > 2 else \
            np.ones(1, np.int64)
        self.warm_tails = mix["final_blocks"] == "warm"
        if not self.warm_tails and mix["final_blocks"] != "distinct":
            raise ValueError(f"final_blocks: {mix['final_blocks']!r}")
        self.rng = np.random.default_rng(seed)
        self.pool = int(mix["pool"])
        self._files: list[File] = []

    def _round(self):
        R = len(self.sizes)
        base = len(self._files)
        for j, i in enumerate(self.rng.permutation(R)):
            k = base + j
            tail = i if self.warm_tails else k
            n = int(self.sizes[i]) // self.N * self.N \
                + int(self.tails[tail % len(self.tails)])
            off = int(self.rng.integers(0, self.max_samples - n + 1))
            self._files.append(File(k, n, k % self.pool, off))

    def file(self, k: int) -> File:
        while len(self._files) <= k:
            self._round()
        return self._files[k]


def units(n: int, N: int, B: int, G: int) -> list:
    """What StreamEncoder sends to the device for one file of n samples
    given whole to process(), then finish(), with blocks of N, batches of
    B frames and super-chunks of up to G batches: ("super", batches),
    ("batch", frames) and ("tail", samples), in stream order."""
    out = []
    buf = n
    for final in (False, True):
        while True:
            avail = buf // N if final else max(0, (buf - 1) // N)
            if avail == 0:
                break
            if avail >= B:
                g = min(avail // B, G)
                out.append(("super", g))
                buf -= g * B * N
            else:
                out.append(("batch", avail))
                buf -= avail * N
    if buf:
        out.append(("tail", buf))
    return out


def warm_lengths(plan: Plan, B: int, G: int) -> list[int]:
    """Lengths of warm-up files that reach every batch shape the mix's
    files send (super-chunks of each size, trimmed batches of each size)
    and end in a block of blocksize - WARM_TAIL samples, a size no file of
    the mix ends in; with warm final blocks, a file of each of them
    besides."""
    N = plan.N
    supers, batches = set(), set()
    for size in plan.sizes:
        for kind, v in units(int(size) // N * N + 1, N, B, G):
            if kind == "super":
                supers.add(v)
            elif kind == "batch":
                batches.add(v)
    supers, batches = sorted(supers), sorted(batches)
    count = max(len(supers), len(batches), 1)
    supers += [0] * (count - len(supers))
    batches += [0] * (count - len(batches))
    out = [(g * B + r) * N + N - WARM_TAIL for g, r in zip(supers, batches)]
    if plan.warm_tails:
        out += [int(plan.tails[i % len(plan.tails)])
                for i in range(len(plan.sizes))]
    return out


def _starts(gen, count: int, samples: int, length: int, device):
    """`count` start samples of stretches of `length`, drawn."""
    room = max(samples - length, 1)
    return (torch.rand(count, generator=gen, device=device,
                       dtype=torch.float64) * room).long().tolist()


def make_buffer(seed: int, index: int, samples: int, channels: int,
                bps: int, rate: int, device, content: dict) -> np.ndarray:
    """[channels, samples] int32 PCM made on `device` from (seed, index)
    by the recipe `content`, returned on the host:
      tones: [[hz, hz added a channel, level], ...], channel c's sine at
        hz + c * that, its phase c plus one drawn a channel;
      noise: Gaussian noise's level;
      envelope: {"hz", "floor"}: the sum is scaled by floor + (1 - floor)
        * (0.5 + 0.5 sin(2 pi hz t + a drawn phase));
      scale: the share of full scale the whole takes;
      bursts (optional): {"per_s", "level", "decay_ms"}: per_s * seconds
        bursts of noise of `level` at drawn places, decaying by e each
        decay_ms;
      pauses (optional): {"share", "seconds", "floor"}: stretches of
        `seconds` at drawn places, `share` of the buffer in all, where
        everything but the noise is scaled by `floor`.
    Levels are shares of the sum's unit, before `scale`."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + index) % (1 << 63))
    full = float((1 << (bps - 1)) - 1)
    f64 = dict(device=device, dtype=torch.float64)
    t = torch.arange(samples, **f64) / rate
    u = torch.rand(2 + channels, generator=gen, **f64).tolist()
    env_cfg = content["envelope"]
    floor = float(env_cfg["floor"])
    env = floor + (1.0 - floor) * (0.5 + 0.5 * torch.sin(
        2 * torch.pi * float(env_cfg["hz"]) * t + 6.283 * u[0]))
    pause = None
    if content.get("pauses"):
        p = content["pauses"]
        length = max(1, round(float(p["seconds"]) * rate))
        count = round(float(p["share"]) * samples / length)
        pause = torch.ones(samples, **f64)
        for s in _starts(gen, count, samples, length, device):
            pause[s:s + length] = float(p["floor"])
    bursts = []
    if content.get("bursts"):
        b = content["bursts"]
        decay = float(b["decay_ms"]) * 1e-3 * rate
        length = max(1, round(5 * decay))
        count = round(float(b["per_s"]) * samples / rate)
        shape = float(b["level"]) * torch.exp(
            -torch.arange(length, **f64) / decay)
        bursts = [(s, shape) for s in _starts(gen, count, samples, length,
                                              device)]
    scale = float(content["scale"]) * full
    out = torch.empty((channels, samples), dtype=torch.int32, device=device)
    for c in range(channels):
        ph = 6.283 * u[2 + c]
        sig = torch.zeros(samples, **f64)
        for hz, per_channel, level in content["tones"]:
            sig += float(level) * torch.sin(
                2 * torch.pi * (float(hz) + c * float(per_channel)) * t
                + c + ph)
        if pause is not None:
            sig *= pause
        sig += float(content["noise"]) * torch.randn(samples, generator=gen,
                                                      **f64)
        for s, shape in bursts:
            n = min(len(shape), samples - s)
            sig[s:s + n] += shape[:n] * torch.randn(n, generator=gen, **f64)
        out[c] = torch.round(sig * env * scale).clamp(-full - 1, full).to(
            torch.int32)
    return out.cpu().numpy()


def check_content(content: dict, bps: int) -> None:
    """The kernels' yardstick (work.py) takes every block of the input to
    hold sound: a recipe whose quietest stretch (the noise under the
    envelope's floor) sits under 2 steps of the format is refused."""
    quiet = float(content["noise"]) * float(content["envelope"]["floor"]) \
        * float(content["scale"]) * ((1 << (bps - 1)) - 1)
    if quiet < 2.0:
        raise ValueError(f"the content's noise floor is {quiet:.3g} steps "
                         f"at {bps} bits: the yardstick assumes no digital "
                         f"silence")


def make_pool(plan: Plan, channels: int, bps: int, device,
              content: dict) -> list:
    return [make_buffer(plan.seed, i, plan.max_samples, channels, bps,
                        plan.rate, device, content)
            for i in range(plan.pool)]
