#!/usr/bin/env python3
"""Smoke test of flac_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, needs one CUDA GPU
    python3 chip_smoke.py --quick    # build + kernel-vs-plain checks only

Phases, in order, each printing one JSON line; any failure exits non-zero:

1. device:  the GPU's name, and nvidia-smi's name and power limit line.
2. build:   nvcc builds the twelve kernel sources of flac_tpu_torch/csrc/
            (pack_fields64.cu, rice_codes.cu, restore.cu,
            assemble_fields.cu, frame_crc.cu, lpc_coeffs.cu,
            rice_cost.cu, candidate_residuals.cu, select_realize.cu,
            channel_candidates.cu, window_autoc.cu, assign_channels.cu;
            one nvcc each, started together) while g++
            builds the native host runtime; the
            probes P1 and P2 run; each kernel's registers, spills and
            static shared memory from ptxas (no kernel may spill), and K3's
            dynamic shared memory (its rings) for each residual width,
            which must equal the host mirror's; the chain probe of
            kernel_variants.py builds beside them.
3. kernels: each kernel against its plain PyTorch version on the GPU:
            K1 bit-identical on random, edge, cluster (ops/pack_synth.py)
            and real-shape field lists; K2 (narrow and wide) on the tile
            tables of real -5 and -8 streams, on synthetic bitstreams and
            on the staging lanes (ops/rice_synth.py): `ovf` identical on
            every lane, the codes on every lane without it; K3 bit-identical
            (PCM and flags) on the corners of ops/restore_synth.py (every
            order bucket, int32 wrap, wide int64, int16 narrowing, 1, 2 and
            6 channels with every stereo assignment, the ring's chunk
            edges, unaligned rows, a 65535-sample frame, a partial CTA,
            taps past 16 bits and out-of-range shifts) and on the first
            native.parse_frames batch of the -5 and -8 clips; K4 (all six
            outputs) and K5 (on the plain deposit of the plain fields)
            bit-identical on the corners of ops/assemble_synth.py; K5 on
            its own corners (assemble_synth.seal_cases: every residue of
            byte_len - 2 mod 16, the longest header, minimal frames, a
            carrying CRC-8 deposit, 1, 64 and 256 frames, and past the
            plain version's domain byte_len - 2 past the row, byte_len
            below 2, an odd W) against the host seal and, in its domain,
            the plain one; K6-K12 on their corners of
            ops/search_synth.py and ops/frontend_synth.py.  Then every
            kernel of an encode program call on its inputs in the ops
            form of real batches, as StreamEncoder uploads them
            (real_batches: 64 frames of the track's recipe at -5, -8 and
            -4, the loose path; 8 frames at -8 -e -p; 64 blocks of the
            33-bit clip, RICE2 and the safe layout; 64 frames of 24-bit
            96 kHz stereo at -5 and -8, of 24-bit 5.1 at -5 and -8 and of
            16-bit mono at -5): K10 (on a 16-bit batch also widened to
            int32), K11, K6 (all five outputs), K8, K7 (all three), K9
            (every SubframeChoice field), K12 on the stereo mid-side path,
            K4 and K5 (on the ops form's words and on the plain deposit of
            the plain fields) bit-identical, K8's residual rows wherever
            their flag holds (a wide fixed or "f64" row whose flag is
            false has no defined residuals:
            residuals_cuda.comparable_rows), and where the batch takes
            the quad layout the chain K4 -> K1 -> K5 byte for byte
            against plain -> plain -> plain.
4. main:    the main path at full size: a 180 s 44.1 kHz 16-bit stereo
            track encoded at -5 (blocksize 4096, 64 frames a batch) on the
            GPU through the compiled encode programs (CUDA graphs: two
            warm-up encodes of the track run each key's ops and capture
            its programs, whose keys, capture times and pools are
            printed; the timed encode replays), then decoded on the GPU
            1024 frames a batch by decode_stream_tpu with engine
            "device" (K2 and K3) and with engine "fast" (the native full
            parse and K3), each with the kernels' launch counts (and K2's
            count of CTAs that staged) read just after (K1 once a
            quad-layout call, K4-K12 once an encode program call, the
            safe tail's too, counted beside them); each decode must give
            the samples back with a matching MD5, equal the port's host
            engine and launch K3 once a decode batch; every CTA of every
            K2 launch must have staged, as the host mirror of the rule
            predicts.  The MB/s of the three engines, the link probe and
            the engine "auto" picks.  Then the track at -8, decoded back
            by the host engine; both streams go to OUT_DIR
            (track_-5.flac, track_-8.flac, ~38 MB; their SHA-256 printed,
            so that two trees' streams can be held equal) for a check
            against flac_tpu on a machine with JAX.
5. ab:      a 20 s clip at -5 through the plain packer must give the same
            bytes as through the kernel; -5, -0 and -8 clips and a transient
            clip (which sends frames through the safe re-encode) must
            round-trip through the reference decoder and through the device
            decode on the GPU; a tolerant decode on the GPU of the -5 clip
            with a corrupted and a cut frame must equal the host engine's
            (samples and errors); the "scan" engine on the GPU must equal
            the host engine on a short -0 clip (blocksize 1152).
hires:      the configurations the main path leaves out, at full size
            (HIRES): 180 s of 24-bit 96 kHz stereo (BASELINE.json config
            3) at -5 and -8, 60 s of 24-bit 48 kHz 5.1 at -5 and -8, 60 s
            of 16-bit 44.1 kHz mono at -5, each
            signals.make_test_signal(n, channels, bits, seed).  For each
            preset: two warm-up encodes capture the keys, a timed
            StreamEncoder encode (blocksize 4096, 64 frames a batch)
            through the compiled programs: MB/s, the stream's SHA-256, and
            the launches, which must be K4, K5, K7, K8, K9, K10, K6 and
            K11 once an encode program call (the replays and the safe
            re-encodes of quad-layout misfits), K12 once a call on the
            stereo mid-side path (none for 5.1 and mono), K1 once a
            quad-layout batch; decodes by "device", "fast" and "host",
            each the source with the MD5 (MB/s), K2 and K3 once a decode
            batch where the engine runs them; K2 (narrow and wide) and K3
            (the fast engine's parse, and int32 residuals and PCM)
            bit-identical to their plain versions on the stream's first
            batch; the stream's first 10 s encoded on the card equal to
            the port's CPU encode (the plain versions) byte for byte.
            Then the two 24-bit sources as WAV files
            (WAVE_FORMAT_EXTENSIBLE) through `python -m
            flac_tpu_torch.cli -8` in one fresh process: each file equal
            to StreamEncoder's bytes with the tool's padding and 10 s seek
            table, K1 once a quad-layout batch; -d in another: the WAVs
            back byte for byte, K2 and K3 once a decode batch.  Each
            path's launches go into the `kernels` line as
            `launches_hires`.
6. times:   each kernel on its real inputs (encode_kernel_times,
            decode_kernel_times): `ms`, its device time per launch
            (torch.profiler; CUDA events around calls queued behind a
            sleep kernel, `ms_queued_events`, beside it, and in its place
            where three traces miss launches, as `ms_by` says),
            `kernel_ms` and `plain_ms`, the kernel's and its plain
            version's time per call (CUDA events around back-to-back
            calls), and its bound: the larger of its bytes (each input
            read once, each output written once) over 3.35 TB/s and its
            operations over 67 T/s, counted as these inputs need them.
            The encode kernels (K10, K11, K6, K8, K7, K9, K12, K4, K1,
            K5) on the ops form's arguments of the track's first 64 frames
            as uploaded (int16) at -5 (`ms`) and -8 (`at_-8`), K4 and K5
            also on its first 256 frames (`at_B256`, the sharded form's
            int32 batch), K5 beside the device time of an empty launch of
            its grid, clusters and shared memory (`empty_launch_ms`); K2
            and K3 on the main path's first decode batch (K2's codes as
            K3's int32 residuals, int16 PCM), K3 also on the "fast"
            engine's input and beside its chain floor (N x the chain
            probe's cycles a sample / the SM clock), with the device
            engine's copy of K2's codes into K3's residual matrix timed
            on its own.  The hires shapes (`at_hires`): every encode
            kernel on 64 frames of 24-bit 96 kHz stereo at -8 (int32
            uploads: K8's "f64" mode, K7's RICE2) and of 24-bit 5.1 at -5
            (K10's channels passing through, no K12), and K2 and K3 on the
            24-bit -8 stream's first decode batch (int32 PCM), the plain
            versions over fewer calls.  K6 also beside its chain floor
            (the dependent float64 operations of the longest problem's
            chain, lpc_cuda.chain_ops, each at its own latency from
            lpc_cuda.op_cycles, over the SM clock) and the earlier
            one-thread design's figure (`chain_floor_ms_before`); K11's
            bound the larger of its bytes and the float32 fmas of the
            blocks whose windowed samples are not all zero
            (`products_nonzero`, every lag of every sample, `products`,
            beside it), and K11 beside one grouped float32 conv1d of the
            windowed rows (`library_ms`, a yardstick the port never
            calls).  K4-K12 carry a one-line `design`.
7. profile: torch.profiler over a 10 s encode (through the graphs,
            and op by op, whose flac.* ranges a replay does not record)
            and 10 s decodes with the "device" and "fast" engines: the
            device's busy share, kernels, graph replays, time by stage
            (the flac.* ranges: flac.candidates; flac.lpc_coeffs,
            flac.residuals, flac.rice and flac.select inside flac.search;
            flac.assign; flac.fields, flac.pack and flac.seal inside
            flac.assemble; the ctypes kernels by name, each beside the
            range that launches it: K10 flac.candidates, K11 and K6
            flac.lpc_coeffs, K8 flac.residuals, K7 flac.rice, K9
            flac.select, K12 flac.assign, K4 flac.fields, K1 flac.pack,
            K5 flac.seal)
            and the top kernels; then through the graphs a 10 s encode of
            24-bit 96 kHz stereo at -8 (the hires configuration: busy
            share and kernel times by name); the tables go to
            OUT_DIR/profile_*.txt.
8. api:     the library API on the GPU.  The 180 s track at -5 in the
            `with` form of StreamEncoder, with a seek table every 10 s, a
            VORBIS_COMMENT, a PICTURE, a progress callback and verify=True:
            the bytes must equal the same encode's with verify=False, K2
            and K3 must launch once for each written super-chunk or batch
            (the callback must see every one), each seek point must land
            on its frame's header; encode MB/s with and without verify,
            beside the main path's encode run just before and just after
            them.  A bit flipped in the packed words on the GPU must make
            verify raise before a frame byte is written.  64 seeded FlacReader reads with the seek
            table (a fresh reader each, seek_absolute) and 64 without must
            equal the source (ms a read).  A 30 s clip through OggFlacSink
            must decode on the GPU (decode_stream_auto) with the MD5, and a
            ranged Ogg decode must equal its slice (MB/s).  In a temp
            directory a Chain edit past the padding and a SimpleIterator
            delete must keep the audio (decoded on the GPU) and the file
            mode.  Each path's K1-K12 launches, counted from 0 just
            before it, go into the `kernels` line as
            `launches_library_api`.
9. cli:     the command lines on the GPU, in a temp directory.  The 180 s
            track as a 16-bit WAV through `python -m flac_tpu_torch.cli -5`
            in a fresh process (MB/s with the process start; the start
            alone as a -t of a one-frame file in another), then the same
            encode in this process through cli.main: both files must equal
            StreamEncoder's bytes with the tool's padding and 10 s seek
            table (that encode and the WAV read and write are timed
            beside it), and K1 must launch once a quad-layout batch.
            -d must give the WAV back byte for byte and -t must pass (K2
            and K3 once a decode batch each); -V must write the same
            bytes (K2 and K3 once a written super-chunk or batch).  The
            file, tagged by metaflac, re-encoded at -8 from FLAC (decoded
            on the GPU): tags kept, round trip, MB/s and size beside -5's.
            On a 30 s clip: --keep-foreign-metadata WAV -> FLAC -> WAV
            byte for byte, --replay-gain tags equal to GainAnalyzer's,
            --ogg then -d, --skip/--until on encode and decode, metaflac
            --list, --add-replay-gain (in its own process, beside the
            33-bit section: it decodes in pure Python; its tags must equal
            --replay-gain's) and --export-tags-to=-, each timed.  A 60 s
            96 kHz 32-bit stereo clip (tests/test_hires.py's recipe, its
            first 4 blocks antiphase so the side passes 2^31) at -5
            through the tool: no K1 (the safe layout), some frame on a side
            channel, decoded by the "device" and "fast" engines with the
            MD5 and equal to the host engine, size within 0.1% of the same
            encode on the CPU.
            Each path's K1-K12 launches, counted from 0 just before
            it, go into the `kernels` line as `launches_cli`.
10. parallel: the parallel paths and the encoder's pipeline, on the
            track's 1937 full blocks.  encode_blocks_dp at -5 in calls of
            256 blocks (the ragged rest last) over data_mesh() and over
            four entries of cuda:0 (a mesh entry may repeat a device): K1
            once an entry a call, the same frames both ways and phase 4's
            bytes, MB/s and peak device memory of each.  decode_frames_dp
            of those frames over 1 and 4 entries: the source, with K3 once
            an entry.  Two processes in a gloo group on cuda:0, each
            encode_file_ranges on the full blocks: the blobs spliced at
            their offsets are the sharded encode's bytes (wall time with
            the process start, each rank's K1 launches).  The corpus
            runner through `python -m torch.distributed.run
            --nproc-per-node 2 -m flac_tpu_torch.parallel.multihost -5` on
            three 30 s WAVs (each rank runs the module's `__main__` from a
            small script that then writes its counts): the round-robin
            lines, StreamEncoder's bytes, K1 once a quad batch of the three
            clips and no K2 or K3.
            The track through StreamEncoder at (pipeline_depth,
            super_batches) = (1, 1), (2, 3) and (6, 8), and (6, 8) with
            verify: phase 4's bytes each, MB/s, remainder fetches, K2 and
            K3 once a written unit under verify.  Each path's launches go
            into the `kernels` line as `launches_parallel` (for the two
            ranks and the corpus runner, the sum of the ranks' own counts,
            each counted from 0 in its process just before its work).
            Each sharded encode is timed after two warm passes over the
            same calls (each shape's program is captured on its second
            call).
11. compiled: the compiled encode programs (encoder._EncodePrograms),
            from an empty cache: for each key, three calls on their own
            inputs (the ops, the capture, a replay) must equal the ops
            form (encoder._encode_batch_ops) on the same inputs in words,
            byte lengths, bits and ok flags, and the counts of K1 and
            K4-K12 must move by the launches its graph holds on every call
            (K4, K5, K7, K8, K9 and K10 one each, K6 and K11 one where the
            preset has LPC, K12 one where it has the mid-side search): -0,
            -5 and -8 at
            64 frames (int16, StreamEncoder's upload) and 256 (int32, the
            sharded form) on the track's blocks, the trimmed 17-frame
            batch, the final short block, a safe re-encode bucket with
            per-frame numbers, 64 blocks of the 33-bit clip (the safe
            layout, no K1), 64 frames of 24-bit 96 kHz stereo at -5 and
            -8 and of 24-bit 5.1 at -5 (int32, as StreamEncoder uploads
            them; no K12 for 5.1), and four shard entries of the card
            (every shard against the ops); each key's capture time, what it
            added to the graph pool and the peak memory of its calls.  A
            replay's copied-out outputs must outlive the next replay of
            the key.  Warm calls and the ops
            form run under torch.cuda.set_sync_debug_mode("error").  One
            64- and one 256-frame call at -5 and one 64-frame call of
            24-bit 96 kHz stereo at -8, ops against replay (in turns: ops,
            replay, replay, ops): host ms (the call), wall ms (with a
            synchronize), event ms (CUDA events around it), kernels and
            their summed device ms (torch.profiler); the track's keys from
            phase 4.  Then the card-only tests (marker `gpu`,
            GPU_TEST_FILES) in a subprocess; their output goes to
            OUT_DIR/gpu_tests.txt.  Each path's launches go into the
            `kernels` line as `launches_compiled_encode`.

On every path of the hires phase and phases 8-11, K4, K5, K7, K8, K9 and
K10 launch equally often, at least as often as K1, K6 (as often as K11)
and K12.  The `kernels` line (K1-K12) comes after phase 11.

The last line is {"ok": true, "device": {...}}.  Longer logs (the compiler's
register report, the profile tables) go to OUT_DIR, beside this script.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, and the
# float32 rate outside the tensor cores, the only non-tensor rate the data
# sheet gives; the kernels' integer operations are counted against it
HBM_BYTES_PER_S = 3.35e12
NON_TENSOR_OPS_PER_S = 67e12
RATE = 44100
TRACK_SECONDS = 180          # one album track: 31.75 MB of 16-bit stereo
DECODE_BATCH = 1024          # frames a decode batch (the reference's)
K2_OPS_PER_CODE = 30         # segment pop, 3 window reads, clz, shifts, zigzag
# K3 a sample: a multiply and an add a tap of the subframe's order, then the
# shift, the residual add, the wasted-bit shift, the stereo undo (~3) and
# the two range compares
K3_OPS_PER_TAP = 2
K3_OPS_PER_SAMPLE = 8
# K4: a field's slot decode, its three stores and the bit-total add; a
# coded sample's zigzag, parameter lookup, shifts and masks, and the quad
# fusion's shift and add
K4_OPS_PER_FIELD = 12
K4_OPS_PER_SAMPLE = 20
# K5 a byte: the table index (shift, xor, mask), its load and the update
K5_OPS_PER_BYTE = 6
# K6 a problem: each Levinson step i's i products and adds, the reflection
# and error update (~8), once; each order's estimates (a log2 and ~5 more
# each: ~15; two without -e, the bits and the test, one with it); a
# candidate's quantizer steps up to its order (~10 each) and its max,
# log2, precision and stores (~40)
K6_OPS_PER_STEP = 8
K6_OPS_PER_ESTIMATE = 15
K6_OPS_PER_QUANT_STEP = 10
K6_OPS_PER_CANDIDATE = 40
# K7 a residual: the zigzag and the OR (~4), then a shift and a 64-bit add
# for each Rice parameter k; a node of the partition tree: a cost and a
# compare for each k
K7_OPS_PER_SAMPLE = 4
K7_OPS_PER_SAMPLE_K = 3
K7_OPS_PER_NODE_K = 6
# what phase 6 prints as each redesigned kernel's `design`
K4_DESIGN = ("a cluster of up to 8 CTAs a frame (at most 512 CTAs a "
             "launch), slots shared out by rank, the bit total pushed to "
             "rank 0 through distributed shared memory")
K7_DESIGN = ("bit counts: a warp transpose and __popc a 32 samples; a tree "
             "of up to 127 nodes costed a thread a node from its 32 counts, "
             "a larger one a warp a node (the cost is convex in k)")
K5_DESIGN = ("a cluster of up to 8 CTAs a frame (one CTA an SM at B=64); "
             "the frame's 8-byte pairs end-aligned, a column of 16-byte "
             "loads a thread, slicing tables, Horner and a tree of constant "
             "powers of x (two lookups each), ranks meeting in rank 0's "
             "shared memory; the CRC-8 by one warp beside them")
K6_DESIGN = ("a group of 8-32 lanes a problem in one-warp CTAs; one "
             "recursion unrolled by order template, each order's error and "
             "coefficients kept by its lane; the estimates side by side, a "
             "shuffle argmin; quantizers stop at the order, precisions "
             "shared out over the lanes")


K8_DESIGN = ("every candidate of a frame and channel candidate in one "
             "CTA of 128 threads, up to 8 CTAs a row sized to one wave "
             "from the occupancy, each a run of 512-sample spans staged by "
             "cp.async through a ring of 4 buffers with a 32-sample "
             "history; 4 consecutive samples a thread, the fixed orders "
             "from its window, the LPC candidates in chunks of up to 5 "
             "with taps outer (a shared load of 4 samples and a broadcast "
             "load of 4 coefficients a candidate feed 16 multiply-adds; "
             "exact float64 fma at 24 bits), 16-byte stores; wide and f64 "
             "flags ORed over a row's cluster in rank 0's shared memory")
K9_DESIGN = ("a CTA of 256 threads a (frame, channel candidate): the "
             "constant test and a thread a candidate's cost, a shuffle "
             "argmin on (bits, index); the winner's residual row copied "
             "with 16-byte loads and stores, only its parameter row read")
# K8 a residual: the fixed orders' differences and masks (~4 a row), an
# LPC tap's multiply-add (1 a tap: the shared loads of the window and
# the coefficients are one a 16 taps), the shift, subtract, mask and
# range test (~5)
K8_OPS_PER_FIXED_SAMPLE = 4
K8_OPS_PER_TAP = 1
K8_OPS_PER_LPC_SAMPLE = 5
# K9 a row: a compare a signal sample (the constant test), a candidate's
# L compares and ~10 for its header and flags, the argmin's ~20 a
# candidate
K9_OPS_PER_SAMPLE = 2
K9_OPS_PER_CANDIDATE = 30
K10_DESIGN = ("two CTAs of 512 threads a frame, each writing a part of "
              "the samples: each reads the frame's rows in full in their "
              "uploaded type, 4 samples of a row a load, each candidate's "
              "OR a warp __reduce_or_sync then the warps', its part of "
              "the rows kept in shared memory, __ffs; its part of the "
              "shifted candidates written with 16-byte stores; no CTA "
              "waits on another")
K11_DESIGN = ("one window: a CTA of 128 threads a row, a thread a Gram "
              "column, the row and the window loaded at once and their "
              "products in shared memory, each column's float32 fmas over "
              "its blocks, a warp's shuffle tree then the warps' halves; "
              "several windows: a CTA of 384 threads two rows, the (row, "
              "window) pairs' windowed samples staged in shared memory "
              "(the windows by cp.async, every copy in flight at once), a "
              "block flagged where not all zero, a warp a (row, window, "
              "lag part), lane j the columns 4j..4j+3, 16-byte shared "
              "loads, only the flagged blocks, a float64 reduce-scatter "
              "tree of shuffles; the combine in ascending window order")
K12_DESIGN = ("a CTA of 256 threads a (frame, output channel): the "
              "first-index argmin of the four totals (or the loose "
              "assignment) in every thread, the chosen candidate's fields "
              "and its residual and signal rows copied with 16-byte loads "
              "and stores")
# what phase 6 prints beside a kernel that no single PyTorch call matches
LIBRARY_NOTES = {
    "pack_fields64": "no single PyTorch call computes this deposit",
    "rice_codes": "no PyTorch call decodes Rice codes",
    "restore": "no PyTorch call computes an integer IIR restore",
    "assemble_fields": "no single PyTorch call builds FLAC field lists",
    "frame_crc": "no PyTorch call computes a CRC",
    "lpc_coeffs": "no PyTorch call runs Levinson-Durbin and the quantizer",
    "rice_cost": "no PyTorch call computes partitioned Rice costs",
    "candidate_residuals": "no single PyTorch call computes the fixed and "
                           "LPC residuals: conv1d has no integer form on the "
                           "card, and the shift, masks and range flags are "
                           "more ops",
    "select_realize": "no single PyTorch call selects and realizes a "
                      "subframe: an argmin, then gathers from five tables",
    "channel_candidates": "no single PyTorch call forms the channel "
                          "candidates and their wasted bits",
    "assign_channels": "no single PyTorch call picks the assignment and "
                       "gathers a subframe choice"}
# K10 a sample pair: two loads, the mid and side, four ORs and compares,
# the four shifts (~14)
K10_OPS_PER_SAMPLE = 14
DESIGNS = {"assemble_fields": K4_DESIGN, "frame_crc": K5_DESIGN,
           "lpc_coeffs": K6_DESIGN, "rice_cost": K7_DESIGN,
           "candidate_residuals": K8_DESIGN, "select_realize": K9_DESIGN,
           "channel_candidates": K10_DESIGN, "window_autoc": K11_DESIGN,
           "assign_channels": K12_DESIGN}
# the range of the ops form that launches each ctypes kernel
ENCODE_KERNEL_RANGES = {"channel_candidates_kernel": "flac.candidates",
                        "window_autoc_kernel": "flac.lpc_coeffs",
                        "assign_channels_kernel": "flac.assign",
                        "lpc_coeffs_kernel": "flac.lpc_coeffs",
                        "candidate_residuals_kernel": "flac.residuals",
                        "rice_cost_kernel": "flac.rice",
                        "select_realize_kernel": "flac.select",
                        "assemble_fields_kernel": "flac.fields",
                        "pack_fields64_kernel": "flac.pack",
                        "frame_crc_kernel": "flac.seal"}


def k11_products_nonzero(x, windows, O: int) -> int:
    """K11's products that an exact implementation must compute: for each
    (row, window), every product d[n] * d[n + l] (n + l < N) whose first
    factor lies in a block of 128 windowed samples d = float32(x) * w that
    are not all zero."""
    import torch
    import torch.nn.functional as F
    N = x.shape[-1]
    K = -(-N // 128)
    d = x.float()[..., None, :] * windows                # [B, CH, W, N]
    live = F.pad(d, (0, K * 128 - N)).reshape(d.shape[:-1] + (K, 128)) \
        .ne(0).any(dim=-1)                              # [B, CH, W, K]
    n = torch.arange(K * 128, device=x.device).reshape(K, 128)
    per_block = sum(((n + l) < N).sum(dim=-1) for l in range(O + 1))
    return int((live.to(torch.int64) * per_block).sum())


def k6_chain_ops_before(O: int, cfg) -> int:
    """K6's chain as the earlier one-thread design counted it
    (dependent float64 operations, each priced as an add): the recursion
    twice without -e, O estimates in a row and 32 quantizer steps a
    candidate, all on one thread."""
    from flac_tpu_torch.ops import lpc_cuda
    recursion = sum(i + 5 for i in range(O))
    per_candidate = 32 * 7 + 10
    cands = lpc_cuda.candidates(1, O, cfg)
    if cfg.do_exhaustive_model_search:
        return recursion + cands * per_candidate
    return 2 * recursion + 3 * O + cands * per_candidate


def ptxas_usage(report: str, kernel: str) -> dict:
    """Registers, spill bytes and static shared memory of each function of
    nvcc's -Xptxas -v `report` whose name contains `kernel`."""
    import re
    out, fn = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1) if kernel in m.group(1) else None
            if fn:
                out[fn] = {}
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[fn]["spill_stores"] = int(m.group(1))
            out[fn]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[fn]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            out[fn]["smem_static_bytes"] = int(m.group(1)) if m else 0
    return out


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def cuda_time_ms(fn, warmup: int = 5, runs: int = 25) -> float:
    """Milliseconds of one call of `fn` on the GPU: CUDA events around
    `runs` back-to-back calls after warm-up, over the count.  Where the
    host launches more slowly than the card runs, this is the host's
    rate."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(runs):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / runs


def queued_device_ms(fn, runs: int = 25) -> float:
    """Device milliseconds of one call of `fn`: the median over `runs` calls
    of CUDA events recorded just before and after each call, all queued
    while a sleep kernel holds the stream, so that the card runs them back
    to back and no host launch gap falls between a pair.  Counts whatever
    else the call launches (a wrapper's fills) with the kernel."""
    import torch
    fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(runs)]
    held = torch.cuda.Event()
    cycles = 1 << 26                     # ~35 ms at the H100's 1.98 GHz
    for _ in range(4):
        torch.cuda._sleep(cycles)
        held.record()
        for a, b in pairs:
            a.record()
            fn()
            b.record()
        # the sleep still running means every call was queued behind it
        queued = not held.query()
        torch.cuda.synchronize()
        if queued:
            return statistics.median(a.elapsed_time(b) for a, b in pairs)
        cycles *= 4
    raise AssertionError("the host could not queue the calls within the "
                         "longest sleep")


def kernel_device_ms(fn, kernel: str, runs: int = 25,
                     attempts: int = 3) -> dict:
    """Device milliseconds of one launch of the CUDA kernel whose name
    contains `kernel`: {"ms", "ms_by" (how "ms" was taken),
    "ms_queued_events" (`queued_device_ms`, always taken beside it)}.
    "ms" comes from torch.profiler's trace of `runs` calls of `fn` after a
    warm call: the kernel alone, without the host's launch gaps, the mean
    over the launches the trace holds.  CUPTI now and then delivers no
    kernel record of a traced window, and often drops one launch's record;
    a trace that holds fewer than `runs` - 1 launches (or more than `runs`)
    is taken again, and after `attempts` such traces "ms" is the queued
    events' time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    queued = queued_device_ms(fn, runs)
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if kernel in e.key]
        count = sum(e.count for e in events)
        if runs - 1 <= count <= runs:
            return {"ms": sum(_device_us(e, True) for e in events) / count
                    / 1e3, "ms_by": "torch.profiler",
                    "profiler_launches": count, "ms_queued_events": queued}
        emit({"phase": "times", "kernel": kernel, "trace": attempt,
              "profiler_launches_seen": count, "expected": runs})
    return {"ms": queued, "ms_by": "cuda events, calls queued",
            "ms_queued_events": queued}


# ---------------------------------------------------------------------------
# phase 3 cases: K1 against its plain version
# ---------------------------------------------------------------------------

def pack_case(rng, B, S, max_pb=60):
    """The random field lists of tests/test_pack_pallas.py."""
    import numpy as np
    pbits = rng.integers(0, max_pb + 1, (B, S))
    pbits[rng.random((B, S)) < 0.08] = 0
    nzeros = rng.integers(0, 4, (B, S))
    pay = rng.integers(0, 1 << 62, (B, S), dtype=np.int64).astype(np.uint64)
    pay &= (np.uint64(1) << pbits.astype(np.uint64)) - np.uint64(1)
    return nzeros.astype(np.int32), pay.view(np.int64), pbits.astype(np.int32)


def pack_cases():
    import numpy as np
    cases = []
    for B, S, W in ((8, 640, 2048), (3, 130, 1024), (16, 352, 4096)):
        rng = np.random.default_rng(B * 1000 + S)
        cases.append((f"random B{B} S{S} W{W}", *pack_case(rng, B, S), W))
    rng = np.random.default_rng(7)
    pb = rng.integers(1, 5, (8, 1024)).astype(np.int32)
    pay = rng.integers(0, 16, (8, 1024)).astype(np.int64) & ((1 << pb) - 1)
    cases.append(("dense small fields", np.zeros((8, 1024), np.int32), pay,
                  pb, 1024))
    rng = np.random.default_rng(63)
    pb = np.full((4, 500), 63, np.int32)
    pay = rng.integers(0, 1 << 63, (4, 500), dtype=np.int64)
    cases.append(("63-bit fields", rng.integers(0, 3, (4, 500)).astype(
        np.int32), pay, pb, 2048))
    # a 63-bit field starting at bit 1..31 of a word spans three words
    nz = rng.integers(1, 32, (4, 300)).astype(np.int32)
    pb = rng.integers(58, 64, (4, 300)).astype(np.int32)
    pay = rng.integers(0, 1 << 62, (4, 300), dtype=np.int64) & (
        (np.int64(1) << pb.astype(np.int64)) - 1)
    cases.append(("three-word straddles", nz, pay, pb, 1024))
    # ~4000 bits into 64 words: everything past word 63 is dropped
    pb = np.full((2, 100), 40, np.int32)
    pay = rng.integers(0, 1 << 40, (2, 100), dtype=np.int64)
    cases.append(("fields past W", np.zeros((2, 100), np.int32), pay, pb,
                  64))
    # the -5 main-path shape: 64 frames of 2263 fields into 8192 words
    rng = np.random.default_rng(5)
    pb = rng.integers(0, 64, (64, 2263)).astype(np.int32)
    nz = rng.integers(0, 8, (64, 2263)).astype(np.int32)
    pay = rng.integers(0, 1 << 62, (64, 2263), dtype=np.int64) & (
        (np.int64(1) << pb.astype(np.int64)) - 1)
    cases.append(("-5 shape B64 S2263 W8192", nz, pay, pb, 8192))
    from flac_tpu_torch.ops import pack_synth
    return cases + [(f"cluster: {c[0]}", *c[1:])
                    for c in pack_synth.cluster_cases()]


# ---------------------------------------------------------------------------
# phase 3 cases: K2 against its plain version
# ---------------------------------------------------------------------------

def stream_batches(stream: bytes):
    """The decode batches of `stream` as the engines form them (each
    (blocksize, channels) group in stream order, DECODE_BATCH frames a
    batch): yields (stream bytes as uint8, frames, frame indices,
    blocksize, channels, bits per sample)."""
    import numpy as np
    from flac_tpu_torch.decoder import scan_frames
    from flac_tpu_torch.ref_decoder import parse_metadata
    st, pos = parse_metadata(stream, 4)
    frames = scan_frames(stream, st, pos)
    groups: dict = {}
    for i, f in enumerate(frames):
        groups.setdefault((f["blocksize"], f["channels"]), []).append(i)
    arr = np.frombuffer(stream, np.uint8)
    for (blocksize, channels), idxs in groups.items():
        for lo in range(0, len(idxs), DECODE_BATCH):
            yield (arr, frames, idxs[lo:lo + DECODE_BATCH], blocksize,
                   channels, st.bits_per_sample)


def decode_batch_inputs(stream: bytes, first_only: bool = False) -> list:
    """The host arrays of each decode batch of `stream` as the device
    engine builds them: [((words2d, lane_start, segs), K2's static
    arguments)], or only the first batch's."""
    from flac_tpu_torch import decoder_device as dd
    out = []
    for arr, frames, idxs, blocksize, channels, _ in stream_batches(stream):
        prep = dd._prep_batch(arr, frames, idxs, blocksize, channels)
        arrays, kw = dd.batch_inputs(arr, *prep)
        out.append((arrays[:3], dict(T=dd._tile_T(blocksize),
                                     NROW=kw["NROW"], SEG=kw["SEG"],
                                     wide=kw["wide"])))
        if first_only:
            break
    return out


def k2_compare(args, kw) -> tuple[bool, int, int]:
    """K2 and its plain version on the same GPU tensors.  Returns (ovf
    identical everywhere and codes identical on every lane without ovf,
    max |difference| of those codes, lanes with ovf)."""
    import torch
    from flac_tpu_torch.ops import bitunpack, rice_cuda
    kres, kovf = rice_cuda.rice_codes(*args, **kw)
    pres, povf = bitunpack.rice_codes_plain(*args, **kw)
    torch.cuda.synchronize()
    keep = ~povf
    same = (kres.dtype == pres.dtype and torch.equal(kovf, povf)
            and torch.equal(kres[:, keep], pres[:, keep]))
    err = 0 if same or not keep.any() else int(
        (kres[:, keep] - pres[:, keep]).abs().max())
    return same, err, int(povf.sum())


def k2_cases(clips: dict):
    """(label, host arrays, static arguments): the first batch of each
    clip's stream, read narrow and wide, and the synthetic bitstreams."""
    from flac_tpu_torch.ops import rice_synth
    cases = []
    for label, stream in clips.items():
        [(arrays, kw)] = decode_batch_inputs(stream, first_only=True)
        for wide in (False, True):
            cases.append((f"{label} stream, {'wide' if wide else 'narrow'}",
                          arrays, dict(kw, wide=wide)))
    for wide in (False, True):
        for lanes in (None, 4096):
            arrays = rice_synth.synthetic_lanes(lanes or 1, wide=wide,
                                                lanes=lanes)
            cases.append((f"synthetic {'wide' if wide else 'narrow'} "
                          f"{len(arrays[1])} lanes", arrays,
                          dict(T=rice_synth.T, NROW=rice_synth.NROW,
                               SEG=rice_synth.SEG, wide=wide)))
        cases.append((f"staging lanes {'wide' if wide else 'narrow'}",
                      rice_synth.staging_lanes(6, wide=wide),
                      dict(T=rice_synth.T, NROW=rice_synth.STAGING_NROW,
                           SEG=rice_synth.SEG, wide=wide)))
    return cases


# ---------------------------------------------------------------------------
# phase 3 cases: K3 against its plain version
# ---------------------------------------------------------------------------

RESTORE_KEYS = ("res", "order", "shift", "qlp", "wasted", "assignment")


def restore_batch_inputs(stream: bytes, first_only: bool = False) -> list:
    """The host arrays of each decode batch of `stream` as the "fast"
    engine gives them to K3 (the native full parse, int16 residuals where
    they fit): [(arrays, K3's static arguments)], or only the first
    batch's."""
    from flac_tpu_torch import decoder_fast as df
    out = []
    for arr, frames, idxs, blocksize, channels, bps in \
            stream_batches(stream):
        pg, asg = df._parse_batch(arr, frames, idxs, blocksize, channels)
        arrays, kw = df.restore_inputs(pg, asg, blocksize, channels, bps)
        out.append((dict(zip(RESTORE_KEYS, arrays)), kw))
        if first_only:
            break
    return out


def k3_compare(t: dict, kw) -> tuple[bool, int]:
    """K3 and its plain version on the same GPU tensors (res cut to the
    blocksize).  Returns (PCM and flags identical, max |difference|)."""
    import torch
    from flac_tpu_torch.ops import bitunpack, restore_cuda
    args = (t["res"][:, :kw["blocksize"]], *(t[k] for k in RESTORE_KEYS[1:]))
    kpcm, koor = restore_cuda.restore_undo(*args, **kw)
    ppcm, poor = bitunpack.restore_undo_body(*args, **kw)
    torch.cuda.synchronize()
    same = (kpcm.dtype == ppcm.dtype and torch.equal(kpcm, ppcm)
            and torch.equal(koor, poor))
    err = 0 if same or kpcm.shape != ppcm.shape else int(
        (kpcm.to(torch.int64) - ppcm.to(torch.int64)).abs().max())
    return same, err


def k3_cases(clips: dict):
    """(label, host arrays, static arguments): the synthetic corners, then
    the first parsed batch of each clip's stream, as the "fast" engine
    gives it (int16 residuals, int16 PCM) and as the "device" engine does
    (int32 residuals)."""
    from flac_tpu_torch.ops import restore_synth
    cases = list(restore_synth.cases())
    for label, stream in clips.items():
        [(arrays, kw)] = restore_batch_inputs(stream, first_only=True)
        cases.append((f"{label} stream, first parsed batch", arrays, kw))
        cases.append((f"{label} stream, int32 residuals, int32 PCM",
                      dict(arrays, res=arrays["res"].astype("int32")),
                      dict(kw, out16=False)))
    return cases


# ---------------------------------------------------------------------------
# phase 3 cases: K4 and K5 against their plain versions
# ---------------------------------------------------------------------------

def upload(pcm, frames: int, bps: int = 16):
    """The first `frames` blocks of 4096 of pcm [C, n] on the card as
    StreamEncoder uploads them: [frames, C, 4096], int16 to 16 bits, else
    int32."""
    import numpy as np
    import torch
    C = pcm.shape[0]
    return torch.from_numpy(np.ascontiguousarray(
        pcm[:, :frames * 4096].reshape(C, frames, 4096).transpose(1, 0, 2),
        np.int16 if bps <= 16 else np.int32)).cuda()


def k4_compare(args) -> tuple[bool, int]:
    """K4 against its plain version: (all six outputs identical, max abs
    difference)."""
    import torch
    from flac_tpu_torch.models import frame as frame_mod
    got = frame_mod.assemble_fields(*args)
    want = frame_mod.assemble_fields_plain(*args)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    err = max(int((a.long() - b.long()).abs().max()) if a.numel() else 0
              for a, b in zip(got, want))
    return same, err


def k5_compare(words, byte_len, hdr_bytes) -> tuple[bool, int]:
    """K5 (on a copy of `words`) against its plain version."""
    import torch
    from flac_tpu_torch.models import frame as frame_mod
    got = frame_mod.seal_frames(words.clone(), byte_len, hdr_bytes)
    want = frame_mod.seal_frames_plain(words, byte_len, hdr_bytes)
    torch.cuda.synchronize()
    err = int((got - want).abs().max()) if got.numel() else 0
    return torch.equal(got, want), err


def plain_pack(fields, args):
    """The plain deposit of K4's or its plain version's fields: (words,
    byte_len)."""
    from flac_tpu_torch.models import frame as frame_mod
    from flac_tpu_torch.ops import bitpack
    choice, signal, _, _, cfg, _, layout = args
    B, C, N = signal.shape
    P = choice.params.shape[-1]
    quad, _ = frame_mod.resolve_layout(cfg, N, P, layout)
    pack = bitpack.pack_fields64 if quad else bitpack.pack_fields
    words, total = pack(fields.nzeros, fields.payload, fields.pbits,
                        frame_mod.max_words(cfg, C, N, P))
    return words, total // 8


# ---------------------------------------------------------------------------
# phase 3 cases: K6 and K7 against their plain versions
# ---------------------------------------------------------------------------

# the dispatchers of an encode program call by kernel: (module under
# flac_tpu_torch, name)
STAGES = {"k10": ("models.stereo", "build_channel_candidates"),
          "k11": ("ops.lpc", "window_autocorrelation"),
          "k6": ("models.subframe", "lpc_candidates"),
          "k8": ("models.subframe", "candidate_residuals"),
          "k7": ("models.subframe", "_rice_cost"),
          "k9": ("models.subframe", "select_and_realize"),
          "k12": ("models.stereo", "assign_channels"),
          "k4": ("models.frame", "assemble_fields"),
          "k1": ("ops.pack_cuda", "pack_fields64"),
          "k5": ("models.frame", "seal_frames")}
SEARCH_STAGES = ("k6", "k8", "k7", "k9")
FRONT_STAGES = ("k10", "k11", "k12")


def capture_ops(x, cfg) -> dict:
    """The arguments of each dispatcher of STAGES (K10, K11, K6, K8, K7,
    K9, K12, K4, K1 where the batch takes the quad layout, K5) in the ops
    form of one encode batch of blocks `x` [B, C, N] on the card,
    blocksize N, by key; their tensors copied (K5 seals its words in
    place)."""
    import importlib

    import torch
    from flac_tpu_torch import encoder as encoder_mod
    mods = {k: importlib.import_module(f"flac_tpu_torch.{m}")
            for k, (m, _) in STAGES.items()}
    seen = {}
    real = {k: getattr(mods[k], name) for k, (_, name) in STAGES.items()}

    def spy(key):
        def call(*a):
            seen[key] = tuple(t.clone() if isinstance(t, torch.Tensor)
                              else t for t in a)
            return real[key](*a)
        return call
    for key, (_, name) in STAGES.items():
        setattr(mods[key], name, spy(key))
    try:
        encoder_mod._encode_batch_ops(
            x, encoder_mod._frame_numbers(0, x.shape[0], x.device), cfg,
            x.shape[2], "auto", "kernel")
    finally:
        for key, (_, name) in STAGES.items():
            setattr(mods[key], name, real[key])
    return seen


def stage_calls(key: str):
    """(the dispatch, the plain version) of K10 ("k10"), K11 ("k11"), K12
    ("k12"), K6 ("k6"), K8 ("k8"), K7 ("k7") or K9 ("k9"), each taking
    the captured arguments."""
    from flac_tpu_torch.models import stereo, subframe
    from flac_tpu_torch.ops import lpc
    if key in SEARCH_STAGES:
        name = STAGES[key][1]
        return getattr(subframe, name), getattr(subframe, f"{name}_plain")
    if key == "k10":
        from flac_tpu_torch.ops import candidates_cuda

        def plain(pcm, cfg):
            out = stereo.build_channel_candidates_plain(pcm, cfg)
            if candidates_cuda.forms(pcm.shape[1], cfg)[2]:
                out += (stereo.loose_assignment(pcm.int(), cfg)[0],)
            return out
        return stereo.build_channel_candidates, plain
    if key == "k11":
        return lpc.window_autocorrelation, lpc.autocorrelation_plain

    def plain12(choice, x, loose, cfg, mid_side=True):
        return stereo.assign_channels_plain(choice, x, loose, cfg)
    return stereo.assign_channels, plain12


def front_compare(key: str, args) -> tuple:
    """K10, K11 or K12 through its dispatch against its plain version on
    CUDA tensors: (every output identical in value and type, max abs
    difference)."""
    import torch
    kernel_fn, plain_fn = stage_calls(key)
    got = kernel_fn(*args)
    want = plain_fn(*args)
    torch.cuda.synchronize()

    def flat(v):
        if isinstance(v, torch.Tensor):
            return [v]
        return [t for item in v for t in flat(item)]
    got, want = flat(got), flat(want)
    same = len(got) == len(want) and all(
        a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
        for a, b in zip(got, want))
    err = max(float((a.double() - b.double()).abs().max())
              if a.numel() and a.shape == b.shape else 0.0
              for a, b in zip(got, want))
    return same, err


def real_search(cfg, pcm, frames: int = 64) -> dict:
    """capture_ops of the first `frames` blocks of pcm [C, n] on the card
    at blocksize cfg.blocksize, as int32."""
    import numpy as np
    import torch
    N, C = cfg.blocksize, pcm.shape[0]
    return capture_ops(torch.from_numpy(np.ascontiguousarray(
        pcm[:, :frames * N].reshape(C, frames, N).transpose(1, 0, 2)))
        .cuda(), cfg)


def real_batches():
    """Phase 3's real batches, made one at a time: (label, resolved
    configuration, the blocks on the card as StreamEncoder uploads them):
    64 frames of the track's recipe at -5, -8 and -4 (the loose path), 8
    frames at -8 -e -p, 64 blocks of the 33-bit clip (int64 signals,
    RICE2, the safe layout), and 64 frames of each hires configuration at
    each of its presets."""
    from flac_tpu_torch import EncoderConfig, signals
    track = signals.make_test_signal(64 * 4096, seed=180)
    for level in (5, 8, 4):
        yield (f"-{level}{' (loose mid-side)' if level == 4 else ''}, "
               "64 frames",
               EncoderConfig.from_preset(level, blocksize=4096).resolve(),
               upload(track, 64))
    yield ("-8 -e -p, 8 frames", EncoderConfig.from_preset(
        8, blocksize=4096, do_exhaustive_model_search=True,
        do_qlp_coeff_prec_search=True).resolve(), upload(track, 8))
    yield ("33-bit side, 64 blocks", EncoderConfig.from_preset(
        5, blocksize=4096, sample_rate=HIRES_RATE,
        bits_per_sample=32).resolve(), upload(hires_clip(), 64, 32))
    for h in HIRES:
        for level in h.presets:
            yield (f"{h.label} -{level}, 64 frames", hires_cfg(h, level),
                   upload(hires_pcm(h, 64 * 4096), 64, h.bps))


def search_compare(kernel_fn, plain_fn, args) -> tuple[bool, int]:
    """A search kernel's dispatch (K6: lpc_candidates, K7: _rice_cost,
    K8: candidate_residuals, K9: select_and_realize) against its plain
    version on CUDA tensors: (every output identical, max abs
    difference).  K8's residual rows count only where their flag holds
    (residuals_cuda.comparable_rows): a wide fixed or "f64" row whose flag
    is false has no defined residuals."""
    import torch
    from flac_tpu_torch.models import subframe
    from flac_tpu_torch.ops import residuals_cuda
    got = kernel_fn(*args)
    want = plain_fn(*args)
    torch.cuda.synchronize()
    if kernel_fn is subframe.candidate_residuals:
        rows = residuals_cuda.comparable_rows(want[2], want[3], args[5],
                                              args[6])
        got = (got[0][rows],) + tuple(got[1:])
        want = (want[0][rows],) + tuple(want[1:])
    same = all(a.shape == b.shape and torch.equal(a, b)
               for a, b in zip(got, want))
    err = max(int((a.long() - b.long()).abs().max())
              if a.numel() and a.shape == b.shape else 0
              for a, b in zip(got, want))
    return same, err


def stage_compare(key: str, args) -> tuple:
    """K6-K12 by key ("k6" to "k12") against its plain version on its
    captured arguments: (identical, max abs difference)."""
    if key in FRONT_STAGES:
        return front_compare(key, args)
    return search_compare(*stage_calls(key), args)


# ---------------------------------------------------------------------------
# phase 6 helpers: each kernel timed on its real inputs beside its bound
# ---------------------------------------------------------------------------

# each kernel's key in STAGES and in the phases' tables -> its name
KERNEL_KEYS = {"k1": "pack_fields64", "k2": "rice_codes", "k3": "restore",
               "k4": "assemble_fields", "k5": "frame_crc",
               "k6": "lpc_coeffs", "k7": "rice_cost",
               "k8": "candidate_residuals", "k9": "select_realize",
               "k10": "channel_candidates", "k11": "window_autoc",
               "k12": "assign_channels"}


def bound(nbytes: int, nops: int) -> dict:
    """The least time the card could take for work that must move `nbytes`
    (each input read once, each output written once) and do `nops`
    operations: the larger of the two times at the data sheet's rates."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = nops / NON_TENSOR_OPS_PER_S * 1e3
    return {"bytes": nbytes, "operations": nops,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def time_kernel(kern, plain, kernel: str, plain_runs: int = 25) -> dict:
    """The device ms of a launch of the CUDA kernel named `kernel` in
    `kern` (kernel_device_ms), and the ms of a call of `kern` and of
    `plain` (cuda_time_ms, in turns plain, kern, kern, plain: the pairs
    bracket drift in the card), the plain version over `plain_runs` calls
    (after 5 warm calls, or 1 where the runs are fewer than 25)."""
    warm = 5 if plain_runs >= 25 else 1
    runs = [cuda_time_ms(plain, warm, plain_runs), cuda_time_ms(kern),
            cuda_time_ms(kern), cuda_time_ms(plain, warm, plain_runs)]
    return {**kernel_device_ms(kern, kernel),
            "kernel_ms": min(runs[1:3]), "plain_ms": min(runs[0], runs[3]),
            "kernel_ms_runs": runs[1:3],
            "plain_ms_runs": [runs[0], runs[3]]}


def k1_work(nzeros, max_words: int) -> tuple:
    """K1's (bytes, operations): each input read once (nzeros, payload,
    pbits), each output written once (the deposit's words are uint32; that
    the kernel stores them zero-extended in int64 is the port's layout,
    not the function's work), and total_bits; per field one scan add,
    three clamped shifts, ORs and index tests, about 16 operations."""
    B, S = nzeros.shape
    return B * S * (4 + 8 + 4) + B * max_words * 4 + B * 4, B * S * 16


def k4_work(args) -> tuple:
    """K4's (B, F, bytes, operations) on its arguments: each input read
    once as the batch needs it (the channel scalars, warm-up and
    coefficients of every subframe, the partition parameters of the orders
    in use, residuals of FIXED and LPC subframes, signal samples of
    VERBATIM ones, the assignment and frame numbers), each output written
    once (nzeros, payload, pbits and the three [B] outputs);
    K4_OPS_PER_FIELD a field, K4_OPS_PER_SAMPLE a coded sample."""
    from flac_tpu_torch.models import frame as frame_mod
    from flac_tpu_torch.ops import assemble_cuda
    ch, sig, cfg, layout = args[0], args[1], args[4], args[6]
    B, C, N = sig.shape
    P = ch.params.shape[-1]
    F = assemble_cuda.field_layout(
        C, N, P, *frame_mod.resolve_layout(cfg, N, P, layout)).F
    fmt = frame_mod.fmt
    has_res = (ch.type_ == fmt.SUBFRAME_TYPE_FIXED) | (
        ch.type_ == fmt.SUBFRAME_TYPE_LPC)
    is_v = ch.type_ == fmt.SUBFRAME_TYPE_VERBATIM
    nbytes = int(B * C * (7 * 4 + 1 + 32 * ch.warmup.element_size()
                          + 32 * 4)
                 + ((1 << ch.po.long()) * 4 * has_res).sum()
                 + has_res.sum() * N * 4
                 + is_v.sum() * N * sig.element_size()
                 + B * (4 + 8) + B * F * 16 + B * 9)
    nops = int(B * F * K4_OPS_PER_FIELD
               + has_res.sum() * N * K4_OPS_PER_SAMPLE)
    return B, F, nbytes, nops


def k5_work(byte_len) -> tuple:
    """K5's (bytes, operations): each frame's bytes under the CRCs read
    once, its length and header length, the 3 CRC bytes written;
    K5_OPS_PER_BYTE a byte."""
    crc_bytes = int((byte_len.long() - 2).clamp(min=0).sum())
    B = int(byte_len.shape[0])
    return crc_bytes + B * 8 + B * 3, crc_bytes * K5_OPS_PER_BYTE


def stage_work(key: str, a, plain_fn, probe: dict, op_cycles: dict,
               sms: int) -> tuple:
    """(bytes, operations, what else the line prints) of K6-K12 by key on
    their captured arguments `a`, counted as these inputs need them; K6
    with its chain floor, K11 with one grouped float32 conv1d of its
    windowed rows as a yardstick (`library_ms`: another rounding, and the
    port never calls it)."""
    import torch.nn.functional as F
    from flac_tpu_torch.ops import autoc_cuda, candidates_cuda, lpc_cuda, \
        residuals_cuda
    if key == "k6":
        autoc, bps_k, _, cfg_k = a
        B6, CH6, A6, O6 = (*autoc.shape[:3], autoc.shape[3] - 1)
        AC6 = lpc_cuda.candidates(A6, O6, cfg_k)
        problems = B6 * CH6 * A6
        ests = 1 if cfg_k.do_exhaustive_model_search else 2
        # what these inputs need: the candidates' own orders
        orders = plain_fn(*a)[2]
        # each input read once (autoc, bps), each output written once (qc,
        # shift, order, precision, ok); the operations of one recursion a
        # problem, its orders' estimates and each candidate's quantizer up
        # to its order
        nbytes = (autoc.numel() * 8 + bps_k.numel() * 4
                  + B6 * CH6 * AC6 * (32 * 4 + 3 * 4 + 1))
        nops = (problems * sum(2 * i + K6_OPS_PER_STEP for i in range(O6))
                + problems * O6 * ests * K6_OPS_PER_ESTIMATE
                + int(orders.sum()) * K6_OPS_PER_QUANT_STEP
                + B6 * CH6 * AC6 * K6_OPS_PER_CANDIDATE)
        # the longest problem's chain, each operation at its own dependent
        # latency; the earlier design's count (every operation as an add,
        # two recursions, 32 quantizer steps) beside it
        chain = lpc_cuda.chain_ops(O6, int(orders.max()))
        before = k6_chain_ops_before(O6, cfg_k)
        return nbytes, nops, {
            "problems": problems, "candidates": B6 * CH6 * AC6,
            "order": O6, "longest_candidate": int(orders.max()),
            "chain_ops": chain, "op_cycles": op_cycles,
            "chain_floor_ms": lpc_cuda.chain_cycles(chain, op_cycles)
            / probe["cycles_per_ns"] / 1e6,
            "chain_ops_before": before,
            "chain_floor_ms_before": before * op_cycles["add"]
            / probe["cycles_per_ns"] / 1e6,
            "ctas": lpc_cuda.ctas(problems, O6),
            "lanes": lpc_cuda.lanes(O6)}
    if key == "k8":
        x8, qc8, _, order8 = a[:4]
        B8, CH8, N8 = x8.shape
        AC8 = qc8.shape[2]
        rows = B8 * CH8
        # each input read once (x, the coefficients, shifts, orders, bps),
        # each output written once (res_all, int32 in every mode,
        # order_all, f_ok, fit_ok); the operations of the fixed rows, and
        # of each LPC candidate's taps to its order
        nbytes = (x8.numel() * x8.element_size()
                  + rows * AC8 * (32 + 2) * 4 + rows * 4
                  + rows * (5 + AC8) * (N8 + 1) * 4 + rows * (5 + AC8))
        taps = int(order8.clamp(max=residuals_cuda.max_taps(
            N8, a[7])).sum())
        nops = (rows * N8 * 5 * K8_OPS_PER_FIXED_SAMPLE
                + taps * N8 * K8_OPS_PER_TAP
                + rows * AC8 * N8 * K8_OPS_PER_LPC_SAMPLE)
        # the library's grid (CTAs a row from the CTAs an SM holds), held
        # against the Python mirror of its rule
        parts8, k8_per_sm = residuals_cuda.grid(x8, a[5], a[6])
        k8_grid = residuals_cuda.ctas(rows, N8, sms * k8_per_sm)
        if k8_grid[0] != parts8:
            raise RuntimeError(f"K8 launches {parts8} CTAs a row, its "
                               f"mirror says {k8_grid}")
        return nbytes, nops, {
            "rows": rows, "N": N8, "candidates": 5 + AC8, "taps": taps,
            "lpc_mode": a[6], "fixed_wide": a[5],
            "ctas": [*k8_grid, rows], "ctas_per_sm": k8_per_sm}
    if key == "k7":
        res_k, _, N_k, max_po_k, cfg_k = a
        rows = res_k.numel() // N_k
        L7, P7 = max_po_k + 1, 1 << max_po_k
        K7 = 31 if cfg_k.rice_param_limit > 15 else 15
        # each input read once (the int32 residuals, the orders), each
        # output written once (bits, parameters, RICE2 flags)
        nbytes = (res_k.numel() * 4 + rows * 4
                  + rows * L7 * (4 + 1) + rows * L7 * P7 * 4)
        nops = rows * (N_k * (K7_OPS_PER_SAMPLE + K7 * K7_OPS_PER_SAMPLE_K)
                       + (2 * P7 - 1) * K7 * K7_OPS_PER_NODE_K)
        return nbytes, nops, {"rows": rows, "N": N_k, "partitions": P7,
                              "parameters": K7}
    if key == "k9":
        x9 = a[0]
        B9, CH9, N9 = x9.shape
        r_bits9, r_ks9 = a[11], a[12]
        C9, L9 = r_bits9.shape[2:]
        P9 = r_ks9.shape[-1]
        AC9 = C9 - 5
        rows = B9 * CH9
        # what these inputs need: x once (the constant test), each
        # candidate's costs, header fields and flags, the winners'
        # residual rows (FIXED and LPC winners only), one parameter row
        # and coefficient row a winner; each output written once
        choice = plain_fn(*a)
        has_res = int((choice.type_ >= 2).sum())
        lpc_w = int((choice.type_ == 3).sum())
        nbytes = (x9.numel() * x9.element_size()
                  + rows * (C9 * L9 * 4 + C9 * 4 + 5 + AC9 * 6 + 8)
                  + has_res * N9 * 4 + rows * (P9 * 4 + 1)
                  + lpc_w * (32 + 2) * 4
                  + rows * (N9 * 4 + P9 * 4 + 32 * 4
                            + 32 * x9.element_size() + 6 * 4 + 1))
        nops = rows * (N9 * K9_OPS_PER_SAMPLE + C9 * K9_OPS_PER_CANDIDATE)
        return nbytes, nops, {"rows": rows, "N": N9, "candidates": C9 + 2,
                              "winners_with_residuals": has_res,
                              "partitions": P9}
    if key == "k10":
        pcm10, cfg10 = a
        B10, C10, N10 = pcm10.shape
        loose10 = candidates_cuda.forms(C10, cfg10)[2]
        x10 = plain_fn(*a)[0]
        CH10 = x10.shape[1]
        # each input read once (the uploaded samples), each output written
        # once (the candidates, bps_eff, wasted, the loose assignment);
        # K10_OPS_PER_SAMPLE a sample pair (half of it a sample that
        # passes through)
        nbytes = (pcm10.numel() * pcm10.element_size()
                  + x10.numel() * x10.element_size()
                  + 2 * B10 * CH10 * 4 + (B10 * 4 if loose10 else 0))
        nops = B10 * N10 * C10 * K10_OPS_PER_SAMPLE // 2
        return nbytes, nops, {
            "frames": B10, "channels": C10, "N": N10,
            "input_dtype": str(pcm10.dtype), "candidates": CH10,
            "ctas": candidates_cuda.ctas(B10, C10, cfg10, sms),
            "staged": candidates_cuda.staged(
                C10, N10, cfg10, candidates_cuda.split(
                    candidates_cuda.units(B10, C10, cfg10), sms))}
    if key == "k11":
        x11, w11, c11, O11 = a
        B11, CH11, N11 = x11.shape
        W11, A11 = w11.shape[0], c11.shape[0]
        rows = B11 * CH11
        # each input read once (x, the windows, the combine), the output
        # written once; the float32 fmas these rows need, two operations
        # each: every product whose first factor lies in a block of 128
        # windowed samples that are not all zero (a block of zeros adds
        # exact zeros, which no exact implementation must compute); every
        # lag of every sample beside it
        nbytes = (x11.numel() * x11.element_size() + w11.numel() * 4
                  + c11.numel() * 8 + rows * A11 * (O11 + 1) * 8)
        products = rows * W11 * sum(N11 - l for l in range(O11 + 1))
        products_nonzero = k11_products_nonzero(x11, w11, O11)
        d = (x11.float()[..., None, :] * w11).reshape(1, rows * W11, N11)
        d_in = F.pad(d, (0, O11))
        d_w = d.reshape(rows * W11, 1, N11)
        library_ms = cuda_time_ms(
            lambda: F.conv1d(d_in, d_w, groups=rows * W11))
        return nbytes, 2 * products_nonzero, {
            "library_ms": library_ms,
            "library_call": f"F.conv1d([1, {rows * W11}, {N11 + O11}] "
                            f"float32, [{rows * W11}, 1, {N11}], "
                            f"groups={rows * W11})",
            "rows": rows, "N": N11, "windows": W11, "apodizations": A11,
            "lags": O11 + 1, "products": products,
            "products_nonzero": products_nonzero,
            "fma_bound_ms_all_products":
                2 * products / NON_TENSOR_OPS_PER_S * 1e3,
            "template_lag": autoc_cuda.template_lag(O11),
            "plan": autoc_cuda.plan(rows, W11, O11)}
    choice12, x12, loose12 = a[:3]
    B12, _, N12 = x12.shape
    P12 = choice12.params.shape[-1]
    xs = x12.element_size()
    # the four candidates' bits (the totals) or the loose assignment read
    # once; a chosen candidate's fields and rows read once and written
    # once a stream channel
    per_channel = (8 * 4 + 1 + 32 * 4 + 32 * xs + P12 * 4 + N12 * 4
                   + N12 * xs)
    nbytes = (B12 * 4 * 4 + (B12 * 4 if loose12 is not None else 0)
              + 2 * 2 * B12 * per_channel + B12 * 4)
    return nbytes, B12 * 2 * 20, {"frames": B12, "N": N12,
                                  "partitions": P12, "ctas": 2 * B12}


def encode_kernel_times(label: str, x, cfg, probe: dict, op_cycles: dict,
                        sms: int, plain_runs: int = 25,
                        keys: tuple | None = None) -> dict:
    """Phase 6 on one encode batch: each kernel of an encode program call
    (K10, K11 and K6 where the preset has LPC, K8, K7, K9, K12 on the
    stereo mid-side path, K4, K1 where the batch takes the quad layout,
    K5) on its arguments in the ops form of the blocks `x` [B, C, N] (as
    StreamEncoder uploads them) at `cfg`: held bit-identical to its plain
    version, then timed (time_kernel) beside its bound, one `times` line
    each; only the kernels of `keys` ("k1" to "k12") where it is given.
    Returns {kernel name: its numbers}."""
    import torch
    from flac_tpu_torch.models import frame as frame_mod
    from flac_tpu_torch.ops import bitpack, pack_cuda
    seen = capture_ops(x, cfg)
    out = {}

    def put(key, kern, plain, work, extra, err):
        name = KERNEL_KEYS[key]
        out[name] = {**time_kernel(kern, plain, f"{name}_kernel",
                                   plain_runs),
                     **bound(*work), "max_abs_err": err, **extra}
        emit({"phase": "times", "kernel": name, "batch": label,
              "input_shape": list(x.shape), "input_dtype": str(x.dtype),
              **out[name]})
    keys = keys or tuple(KERNEL_KEYS)
    for key in (*FRONT_STAGES, *SEARCH_STAGES):
        a = seen.get(key)
        if key not in keys or a is None or key == "k12" and not a[-1]:
            continue            # no LPC, or no mid-side search: no launch
        ok, err = stage_compare(key, a)
        if not ok:
            raise AssertionError(f"{KERNEL_KEYS[key]} differs from its "
                                 f"plain version on {label}")
        kern_fn, plain_fn = stage_calls(key)
        nbytes, nops, extra = stage_work(key, a, plain_fn, probe,
                                         op_cycles, sms)
        put(key, lambda a=a, f=kern_fn: f(*a), lambda a=a, f=plain_fn: f(*a),
            (nbytes, nops), extra, err)
    a4 = seen["k4"]
    ok, err = k4_compare(a4)
    if not ok:
        raise AssertionError(f"K4 differs from its plain version on {label}")
    B, F, nbytes, nops = k4_work(a4)
    if "k4" in keys:
        put("k4", lambda: frame_mod.assemble_fields(*a4),
            lambda: frame_mod.assemble_fields_plain(*a4), (nbytes, nops),
            {"B": B, "F": F}, err)
    if "k1" in seen and "k1" in keys:
        nz, pay, pb, W = seen["k1"]
        kw, kt = pack_cuda.pack_fields64(nz, pay, pb, W)
        pw, pt = bitpack.pack_fields64(nz, pay, pb, W)
        torch.cuda.synchronize()
        if not (torch.equal(kw, pw) and torch.equal(kt, pt)):
            raise AssertionError(f"K1 differs from its plain version on "
                                 f"{label}")
        put("k1", lambda: pack_cuda.pack_fields64(nz, pay, pb, W),
            lambda: bitpack.pack_fields64(nz, pay, pb, W), k1_work(nz, W),
            {"B": int(nz.shape[0]), "S": int(nz.shape[1]), "W": W}, 0)
    w5, bl5, hb5 = seen["k5"]
    ok, err = k5_compare(w5, bl5, hb5)
    if not ok:
        raise AssertionError(f"K5 differs from its plain version on {label}")
    w5k = w5.clone()                  # K5 seals in place: time on a copy
    if "k5" in keys:
        put("k5", lambda: frame_mod.seal_frames(w5k, bl5, hb5),
            lambda: frame_mod.seal_frames_plain(w5, bl5, hb5), k5_work(bl5),
            {"B": int(bl5.shape[0]), "frame_bytes": int(bl5.sum())}, err)
    return out


def decode_kernel_times(stream: bytes, probe: dict,
                        plain_runs: int = 5) -> dict:
    """Phase 6 on one decode batch: K2 and K3 on the first decode batch of
    `stream` as the "device" engine gives it (K2's codes as K3's [S, N]
    int32 residuals, the PCM in the stream's width: int16 to 16 bits,
    else int32), each held bit-identical to its plain version and timed
    beside its bound; K3 also on the "fast" engine's input (int16
    residuals where they fit) and beside its chain floor (N x the chain
    probe's cycles a sample, folded form, over the SM clock), and the
    engine's copy of K2's codes into K3's residual matrix, timed on its
    own.  Returns {kernel name: its numbers}."""
    import numpy as np
    import torch
    from flac_tpu_torch import decoder_device as dd
    from flac_tpu_torch.ops import bitunpack, restore_cuda, rice_cuda
    arr, frames, idxs, N, C, bps = next(stream_batches(stream))
    barrays, bkw = dd.batch_inputs(arr, *dd._prep_batch(arr, frames, idxs,
                                                        N, C))
    t = [torch.from_numpy(a).cuda() for a in barrays]
    k2kw = dict(T=dd._tile_T(N), NROW=bkw["NROW"], SEG=bkw["SEG"],
                wide=bkw["wide"])
    ok, err2, n_ovf = k2_compare(t[:3], k2kw)
    if not ok:
        raise AssertionError("K2 differs from its plain version on the "
                             "stream's first decode batch")
    # each input read once (the batch's stream words, lane_start, the SEG
    # segment slots of each lane), each output written once (res [T, L]
    # int32 or int64, ovf one byte a lane); the operations count the codes
    # this batch really decodes (real segments, at most T a lane)
    T, SEG, L = k2kw["T"], k2kw["SEG"], barrays[1].shape[0]
    counts = ((barrays[2] >> 7) & 0xFF) * (barrays[2] != bitunpack.SEG_INERT)
    codes = int(counts.sum(axis=1).clip(max=T).sum())
    k2 = {**time_kernel(lambda: rice_cuda.rice_codes(*t[:3], **k2kw),
                        lambda: bitunpack.rice_codes_plain(*t[:3], **k2kw),
                        "rice_codes_kernel", plain_runs),
          **bound(barrays[0].nbytes + L * 4 + L * SEG * 4
                  + T * L * (8 if k2kw["wide"] else 4) + L,
                  codes * K2_OPS_PER_CODE),
          "max_abs_err": err2, "L": L, "NROW": k2kw["NROW"], "SEG": SEG,
          "T": T, "wide": k2kw["wide"], "codes": codes, "ovf_lanes": n_ovf}
    res_tl, _ = rice_cuda.rice_codes(*t[:3], **k2kw)
    S = t[3].shape[0]
    transpose_ms = queued_device_ms(lambda: res_tl.t().reshape(S, -1))
    k3args = (res_tl.t().reshape(S, -1)[:, :N], *t[3:])
    k3kw = dict(blocksize=N, channels=C, max_order=bkw["max_order"],
                wide=bkw["wide"], out16=bps <= 16, bps=bps)
    ok, err3 = k3_compare(dict(zip(RESTORE_KEYS, k3args)), k3kw)
    if not ok:
        raise AssertionError("K3 differs from its plain version on the "
                             "stream's first decode batch")
    [(farrays, fkw)] = restore_batch_inputs(stream, first_only=True)
    ft = {k: torch.from_numpy(v).cuda() for k, v in farrays.items()}
    ok, _ = k3_compare(ft, fkw)
    if not ok:
        raise AssertionError("K3 differs from its plain version on the "
                             "fast engine's first batch")
    fargs = (ft["res"], *(ft[k] for k in RESTORE_KEYS[1:]))
    fast = kernel_device_ms(lambda: restore_cuda.restore_undo(*fargs, **fkw),
                            "restore_kernel")
    # each input read once (res as the device engine hands it over, in
    # int32; order, shift, wasted, the taps, the assignments), each output
    # written once (the PCM, a flag a frame); the operations count each
    # subframe's own order, not the bucket's
    B = S // C
    out_bytes = 2 if k3kw["out16"] else 8 if k3kw["wide"] else 4
    k3 = {**time_kernel(lambda: restore_cuda.restore_undo(*k3args, **k3kw),
                        lambda: bitunpack.restore_undo_body(*k3args, **k3kw),
                        "restore_kernel", 1),
          **bound(S * N * 4 + S * 4 * 3 + S * bkw["max_order"] * 4 + B * 4
                  + S * N * out_bytes + B,
                  int(N * (K3_OPS_PER_TAP * barrays[3].astype(np.int64)
                           + K3_OPS_PER_SAMPLE).sum())),
          "max_abs_err": err3, "S": S, "N": N, "channels": C,
          "max_order": bkw["max_order"],
          "out_dtype": "int16" if k3kw["out16"] else "int32",
          "ms_fast_engine_input": fast["ms"],
          "ms_fast_engine_input_by": fast["ms_by"],
          "fast_engine_res_dtype": str(farrays["res"].dtype),
          "chain_probe": probe,
          "chain_floor_ms": N * probe["folded_cycles_per_sample"]
          / probe["cycles_per_ns"] / 1e6,
          "transpose_copy_ms": transpose_ms,
          "transpose_copy": {"shape": list(res_tl.shape),
                             "dtype": str(res_tl.dtype)},
          "smem_dynamic_bytes": restore_cuda.smem_bytes(4, bkw["wide"])}
    for name, entry in (("rice_codes", k2), ("restore", k3)):
        emit({"phase": "times", "kernel": name, **entry})
    return {"rice_codes": k2, "restore": k3}


# ---------------------------------------------------------------------------
# phases 4-5 helpers
# ---------------------------------------------------------------------------

def batch_blocksizes(cfg, n_samples: int, batch_frames: int) -> list:
    """The blocksize of each batch a StreamEncoder run writes."""
    N = cfg.blocksize
    full = (n_samples - 1) // N                    # emitted before finish
    sizes = [N] * (-(-full // batch_frames))
    rest = n_samples - full * N
    sizes += [N] * (rest // N)
    if rest % N:
        sizes.append(rest % N)
    return sizes


def written_units(cfg, n_samples: int, batch_frames: int,
                  super_batches: int = 8) -> list:
    """The frames of each unit (super-chunk or batch) that a StreamEncoder
    run writes, by its buffering rule: super-chunks of up to
    super_batches full batches, then a batch of the full blocks left, then
    the final short block."""
    N, B = cfg.blocksize, batch_frames
    units = []

    def drain(avail):
        while avail:
            take = (min(avail // B, super_batches) * B if avail >= B
                    else avail)
            units.append(take)
            avail -= take
    full = (n_samples - 1) // N                    # emitted before finish
    drain(full)
    rest = n_samples - full * N
    drain(rest // N)
    if rest % N:
        units.append(1)
    return units


def quad_batches(cfg, n_samples: int, batch_frames: int) -> int:
    """Batches of a StreamEncoder run that take the quad layout (and so
    launch K1 once each), from the frame plan alone."""
    from flac_tpu_torch import format as fmt

    def quad(n):
        po = fmt.max_rice_partition_order_limited(
            cfg.max_residual_partition_order, n, 0)
        return (cfg.bits_per_sample <= 26 and n % 4 == 0
                and max(n >> po, 1) % 4 == 0)
    return sum(quad(n) for n in batch_blocksizes(cfg, n_samples,
                                                 batch_frames))


def round_trip(stream: bytes, pcm) -> float:
    """Decode with the package's reference decoder (it checks every CRC and
    the STREAMINFO MD5); the samples must equal pcm.  Returns seconds."""
    import numpy as np
    from flac_tpu_torch import ref_decoder
    t0 = time.perf_counter()
    st = ref_decoder.decode_stream(stream, verify_md5=True)
    if st.md5 == b"\x00" * 16:
        raise AssertionError("stream carries no MD5")
    if not np.array_equal(st.samples, pcm):
        raise AssertionError("decoded samples differ from the input")
    return time.perf_counter() - t0


def device_round_trip(stream: bytes, pcm) -> float:
    """Decode on the GPU through K2 (decode_stream_tpu, engine "device":
    every CRC and the MD5 checked); the samples must equal pcm.  Returns
    seconds."""
    import numpy as np
    import torch
    from flac_tpu_torch import decode_stream_tpu
    t0 = time.perf_counter()
    st = decode_stream_tpu(stream, engine="device")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not st.md5_ok or not np.array_equal(st.samples, pcm):
        raise AssertionError("the device decode differs from the input")
    return wall


def decode_batches(frames: list) -> int:
    """Decode batches of the device engine (one K2 launch each): each
    (blocksize, channels) group in batches of up to DECODE_BATCH frames."""
    groups: dict = {}
    for f in frames:
        key = (f["blocksize"], f["channels"])
        groups[key] = groups.get(key, 0) + 1
    return sum(-(-n // DECODE_BATCH) for n in groups.values())


def encode(pcm, level: int, blocksize: int = 4096, rate: int = RATE,
           bps: int = 16, **kw):
    """pcm [C, n] through StreamEncoder on the card at -`level`, 64 frames
    a batch: (the stream's bytes, the encoder)."""
    from flac_tpu_torch import EncoderConfig
    from flac_tpu_torch.encoder import StreamEncoder
    buf = io.BytesIO()
    enc = StreamEncoder(buf, EncoderConfig.from_preset(
        level, blocksize=blocksize, sample_rate=rate, channels=pcm.shape[0],
        bits_per_sample=bps), device="cuda", batch_frames=64, **kw)
    enc.process(pcm)
    enc.finish()
    return buf.getvalue(), enc


# ---------------------------------------------------------------------------
# phase 8: the library API on the card
# ---------------------------------------------------------------------------

API_READS = 64               # seeded FlacReader reads, with and without a table
OGG_SECONDS = 30


# each kernel's name in the `kernels` line -> its wrapper's module in
# flac_tpu_torch.ops, which counts its launches
KERNEL_MODULES = {"pack_fields64": "pack_cuda", "rice_codes": "rice_cuda",
                  "restore": "restore_cuda",
                  "assemble_fields": "assemble_cuda",
                  "frame_crc": "seal_cuda",
                  "lpc_coeffs": "lpc_cuda",
                  "rice_cost": "rice_cost_cuda",
                  "candidate_residuals": "residuals_cuda",
                  "select_realize": "select_cuda",
                  "channel_candidates": "candidates_cuda",
                  "window_autoc": "autoc_cuda",
                  "assign_channels": "assign_cuda"}


def _wrappers() -> dict:
    import importlib
    return {name: importlib.import_module(f"flac_tpu_torch.ops.{mod}")
            for name, mod in KERNEL_MODULES.items()}


def _reset_counts():
    for mod in _wrappers().values():
        mod.launches = 0


def _counts() -> dict:
    return {name: mod.launches for name, mod in _wrappers().items()}


def _k123(c: dict) -> dict:
    """A path's launches of K1, K2 and K3."""
    return {k: c[k] for k in ("pack_fields64", "rice_codes", "restore")}


def check_encode_calls(phase: str, launches: dict) -> None:
    """Every encode program call launches K4, K5, K7, K8, K9 and K10 once,
    K6 and K11 once where its preset has LPC, K12 once where it has the
    stereo mid-side search, and K1 once where it takes the quad layout:
    on each path K4 == K5 == K7 == K8 == K9 == K10 >= K1, K6 == K11, K12,
    and a path that launched K1 launched K4."""
    for path, c in launches.items():
        k1, k4, k5, k6, k7, k8, k9, k10, k11, k12 = (
            c["pack_fields64"], c["assemble_fields"], c["frame_crc"],
            c["lpc_coeffs"], c["rice_cost"], c["candidate_residuals"],
            c["select_realize"], c["channel_candidates"],
            c["window_autoc"], c["assign_channels"])
        if not k4 == k5 == k7 == k8 == k9 == k10 or k6 != k11 \
                or k4 < max(k1, k6, k12):
            raise AssertionError(f"{phase}, {path}: K4 {k4}, K5 {k5}, K7 "
                                 f"{k7}, K8 {k8}, K9 {k9}, K10 {k10}, K1 "
                                 f"{k1}, K6 {k6}, K11 {k11}, K12 {k12}: "
                                 "not K4 == K5 == K7 == K8 == K9 == K10 >= "
                                 "K1, K6 == K11, K12")


def _api_extra():
    """A VORBIS_COMMENT and a PICTURE as raw (type, body) blocks."""
    from flac_tpu_torch import metadata as md
    vc = md.VorbisCommentBlock()
    vc.set("TITLE", "chip smoke")
    vc.set("ARTIST", "flac_tpu_torch")
    pic = md.PictureBlock(picture_type=3, mime_type="image/png",
                          description="cover", width=1, height=1, depth=24,
                          data=b"\x89PNG\r\n\x1a\n" + bytes(4000))
    return [(vc.TYPE, vc.to_bytes()), (pic.TYPE, pic.to_bytes())]


def _api_encode(pcm, verify: bool, out=None, **kw):
    """The 180 s track at -5 through the `with` form of StreamEncoder on
    the card, with a seek table every 10 s, tags and a picture.  Returns
    (stream bytes or None, progress calls, wall seconds, launches, the
    encoder)."""
    import torch
    from flac_tpu_torch import EncoderConfig
    from flac_tpu_torch import metadata as md
    from flac_tpu_torch.encoder import StreamEncoder
    buf = out if out is not None else io.BytesIO()
    calls = []
    _reset_counts()
    t0 = time.perf_counter()
    with StreamEncoder(
            buf, EncoderConfig.from_preset(5, blocksize=4096),
            device="cuda", batch_frames=64, verify=verify,
            seektable=md.SeekTableBlock.template_spaced(pcm.shape[1], RATE,
                                                        10.0),
            extra_metadata=_api_extra(),
            progress_callback=lambda *a: calls.append(a), **kw) as enc:
        enc.process(pcm)
        enc.finish()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (buf.getvalue() if out is None else None), calls, wall, \
        _counts(), enc


def library_api(pcm, plain_stream: bytes, expect_quad: int) -> dict:
    """Phase 8.  Raises AssertionError on the first check that fails.
    Returns each path's kernel launches, as counted from 0 just before it
    and read just after."""
    import tempfile

    import numpy as np
    import torch
    from flac_tpu_torch import EncoderConfig, decode_stream_tpu, ogg
    from flac_tpu_torch import encoder as encoder_mod
    from flac_tpu_torch import metadata as md
    from flac_tpu_torch.decoder import decode_stream_auto, parse_frame_header
    from flac_tpu_torch.encoder import StreamEncoder
    from flac_tpu_torch.ref_decoder import parse_metadata
    from flac_tpu_torch.seek import FlacReader
    launches = {}
    pcm_bytes = pcm.size * 2

    def control_wall():
        """The main path's encode (no API feature) in this phase's host
        state: the control that the API encodes' MB/s are read against."""
        t0 = time.perf_counter()
        encode(pcm, 5)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    # verify on the card: K2 and K3 once for each written super-chunk or
    # batch
    c_walls = [control_wall()]
    stream, calls, v_wall, launches["verify_encode"], enc = _api_encode(
        pcm, True)
    unverified, _, u_wall, launches["encode_with_metadata"], _ = \
        _api_encode(pcm, False)
    c_walls.append(control_wall())
    n_frames = -(-pcm.shape[1] // 4096)
    v = launches["verify_encode"]
    steps = np.diff([0] + [c[0] for c in calls])
    emit({"phase": "api",
          "case": f"verify encode, -5, {pcm.shape[1] // RATE} s",
          "encode_mb_per_s": {"verify": pcm_bytes / 1e6 / v_wall,
                              "no_verify": pcm_bytes / 1e6 / u_wall,
                              "main_path_config": [pcm_bytes / 1e6 / w
                                                   for w in c_walls]},
          "encode_wall_s": {"verify": v_wall, "no_verify": u_wall,
                            "main_path_config": c_walls},
          "written_units": len(calls), "launches": v,
          "launches_without_verify": launches["encode_with_metadata"],
          "bytes": len(stream)})
    if stream != unverified:
        raise AssertionError("the verify=True stream differs from the "
                             "verify=False stream")
    if v["rice_codes"] != len(calls) or v["restore"] != len(calls):
        raise AssertionError(f"verify launched K2/K3 {v} for {len(calls)} "
                             "written units: not once a unit")
    if v["pack_fields64"] != expect_quad or \
            _k123(launches["encode_with_metadata"]) != {
                "pack_fields64": expect_quad, "rice_codes": 0, "restore": 0}:
        raise AssertionError(f"K1 launches {v}, "
                             f"{launches['encode_with_metadata']}, expected "
                             f"{expect_quad} and no decode without verify")
    if calls[-1][0] != n_frames or steps.min() < 1 or steps.max() > 64 * 8:
        raise AssertionError(f"the progress callback missed units: {calls}")
    st, first = parse_metadata(stream, 4)
    if first != enc._first_frame_offset or \
            stream[first:] != plain_stream[parse_metadata(plain_stream,
                                                          4)[1]:]:
        raise AssertionError("the frames differ from the main path's encode "
                             "of the same track")
    table = md.Chain.read(stream).get(md.SeekTableBlock.TYPE)
    points = [p for p in table.points if not p.is_placeholder]
    for p in points:
        h = parse_frame_header(stream, first + p.stream_offset, st)
        if h is None or h["number"] * 4096 != p.sample_number:
            raise AssertionError(f"seek point {p} is not on its frame")
    if len(points) != -(-pcm.shape[1] // (10 * RATE)) or \
            not table.is_legal():
        raise AssertionError(f"seek table: {len(points)} points")
    emit({"phase": "api", "case": "seek table", "points": len(points),
          "on_frame_headers": True,
          "blocks": [t for t, _ in md.parse_metadata_blocks(stream)]})

    # verify must catch a bit flipped in the packed words on the card (the
    # pipeline encodes the later batches, the one-frame tail too, before
    # it verifies the first)
    real = encoder_mod.encode_batch

    def corrupted(*a, **k):
        pf = real(*a, **k)
        words = pf.words.clone()
        words[min(3, words.shape[0] - 1), 40] ^= 1 << 11
        return pf._replace(words=words)
    encoder_mod.encode_batch = corrupted
    out = io.BytesIO()
    try:
        _api_encode(pcm[:, :20 * RATE], True, out=out)
    except RuntimeError as e:
        caught = str(e)
    else:
        caught = None
    finally:
        encoder_mod.encode_batch = real
    # what reached the output must be the stream header and nothing more
    written = out.getvalue()
    header = parse_metadata(written, 4)[1]
    emit({"phase": "api", "case": "verify catches a flipped bit",
          "raised": caught, "bytes_written": len(written),
          "header_bytes": header})
    if caught is None or "stream NOT written" not in caught or \
            len(written) != header:
        raise AssertionError("verify let a corrupted batch through")

    # seeking: 64 seeded reads with the seek table (a fresh reader each,
    # seek_absolute from the best point) and 64 without (one reader)
    rng = np.random.default_rng(64)
    starts = rng.integers(0, pcm.shape[1] - 1, API_READS)
    lens = rng.integers(1, 4 * 4096, API_READS)
    FlacReader(plain_stream).read_range(0, 4096)            # warm-up
    read_ms = {}
    for label, data in (("with_table", stream),
                        ("no_table", plain_stream)):
        rd = FlacReader(data)
        _reset_counts()
        t0 = time.perf_counter()
        for s0, n in zip(starts, lens):
            s0, n = int(s0), int(n)
            if label == "with_table":
                rd = FlacReader(data)
                rd.seek_absolute(s0)
                got = rd.read(n)
            else:
                got = rd.read_range(s0, n)
            if not np.array_equal(got, pcm[:, s0:s0 + n]):
                raise AssertionError(f"read {label} at {s0}+{n} differs")
        torch.cuda.synchronize()
        read_ms[label] = (time.perf_counter() - t0) * 1e3 / API_READS
        c = launches[f"reader_{label}"] = _counts()
        if c["rice_codes"] < API_READS or c["restore"] < API_READS:
            raise AssertionError(f"{API_READS} reads {label} launched {c}")
    emit({"phase": "api", "case": f"FlacReader, {API_READS} seeded reads",
          "ms_per_read": read_ms,
          "launches": {k: launches[f"reader_{k}"] for k in read_ms}})

    # Ogg: a 30 s clip at -5 through OggFlacSink, decoded on the card
    clip = pcm[:, :OGG_SECONDS * RATE]
    buf = io.BytesIO()
    sink = ogg.OggFlacSink(buf)
    _reset_counts()
    with StreamEncoder(sink, EncoderConfig.from_preset(5, blocksize=4096),
                       device="cuda", batch_frames=64) as enc:
        enc.process(clip)
        enc.finish()
    sink.finalize()
    launches["ogg_encode"] = _counts()
    data = buf.getvalue()
    decode_stream_auto(data)                                # warm-up
    _reset_counts()
    t0 = time.perf_counter()
    st = decode_stream_auto(data)
    torch.cuda.synchronize()
    ogg_s = time.perf_counter() - t0
    launches["ogg_decode"] = _counts()
    if not st.md5_ok or not np.array_equal(st.samples, clip):
        raise AssertionError("the Ogg decode differs from the clip")
    lo, n = 11 * RATE + 123, 7 * RATE
    _reset_counts()
    mid = ogg.decode_ogg_flac_range(data, lo, n)
    launches["ogg_range"] = _counts()
    if not np.array_equal(mid.samples, clip[:, lo:lo + n]):
        raise AssertionError("the ranged Ogg decode differs from the clip")
    emit({"phase": "api", "case": f"Ogg, -5, {OGG_SECONDS} s",
          "bytes": len(data), "decode_s": ogg_s,
          "decode_mb_per_s": clip.size * 2 / 1e6 / ogg_s,
          "md5": "match", "range": [lo, n],
          "launches": {k: launches[k] for k in ("ogg_encode", "ogg_decode",
                                                "ogg_range")}})
    if min(launches["ogg_decode"]["rice_codes"],
           launches["ogg_decode"]["restore"],
           launches["ogg_range"]["rice_codes"],
           launches["ogg_range"]["restore"],
           launches["ogg_encode"]["pack_fields64"]) < 1:
        raise AssertionError(f"the Ogg decodes did not run K2 and K3: "
                             f"{launches}")

    # metadata: a Chain edit past the padding, a SimpleIterator delete
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "track.flac")
        with open(path, "wb") as f:
            f.write(stream)
        os.chmod(path, 0o640)
        ch = md.Chain.read_file(path)
        ch.get(md.VorbisCommentBlock.TYPE).set("LYRICS", "la " * 4000)
        ch.write_file(path)
        with md.SimpleIterator(path) as it:
            while it.get_block_type() != md.PictureBlock.TYPE:
                it.next()
            it.delete_block(use_padding=False)
        with open(path, "rb") as f:
            edited = f.read()
        mode = os.stat(path).st_mode & 0o777
        _reset_counts()
        st = decode_stream_tpu(edited)
        torch.cuda.synchronize()
        launches["decode_after_edit"] = _counts()
    blocks = [t for t, _ in md.parse_metadata_blocks(edited)]
    emit({"phase": "api", "case": "metadata edit",
          "bytes": [len(stream), len(edited)], "blocks": blocks,
          "mode": oct(mode), "launches": launches["decode_after_edit"]})
    if not st.md5_ok or not np.array_equal(st.samples, pcm) or \
            mode != 0o640 or md.PictureBlock.TYPE in blocks or \
            len(edited) <= len(stream) or \
            edited[parse_metadata(edited, 4)[1]:] != stream[first:]:
        raise AssertionError("the edited file lost its audio, its mode or "
                             "the edit")
    return launches


# ---------------------------------------------------------------------------
# phase 9: the command lines on the card
# ---------------------------------------------------------------------------

CLIP_SECONDS = 30            # the host features' clip
HIRES_SECONDS = 60           # the 33-bit clip: a 32-bit stereo file at
HIRES_RATE = 96000           # 96 kHz of signals.make_hires32_signal's samples


def hires_clip():
    """The 33-bit clip: HIRES_SECONDS of signals.make_hires32_signal at
    HIRES_RATE, its first 4 blocks antiphase so the side passes 2^31."""
    import numpy as np
    from flac_tpu_torch import signals
    hi = signals.make_hires32_signal(HIRES_SECONDS * HIRES_RATE, seed=60)
    left = np.round(1.6e9 * np.sin(np.arange(4 * 4096) * 0.01))
    hi[0, :4 * 4096], hi[1, :4 * 4096] = left, -left
    return hi


def _cli_process(argv) -> float:
    """`python -m flac_tpu_torch.cli argv` in a fresh process, the way a
    user runs it.  Returns its wall seconds."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "flac_tpu_torch.cli",
                          *argv], cwd=HERE, capture_output=True, text=True,
                         timeout=600)
    wall = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"python -m flac_tpu_torch.cli {argv} exited "
                             f"{out.returncode}: {out.stderr[-3000:]}")
    return wall


def _wav_with_chunks(pcm) -> bytes:
    """A 16-bit WAV with a LIST chunk before its data and an odd-sized
    chunk after it (the foreign metadata that flac keeps)."""
    import struct
    from flac_tpu_torch import container
    payload = container._pcm_to_bytes(pcm, 16)
    fmtc = struct.pack("<HHIIHH", 1, 2, RATE, RATE * 4, 4, 16)
    info = b"INFOIART" + struct.pack("<I", 11) + b"chip smoke\x00\x00"
    chunks = (b"fmt " + struct.pack("<I", len(fmtc)) + fmtc
              + b"LIST" + struct.pack("<I", len(info)) + info
              + b"data" + struct.pack("<I", len(payload)) + payload
              + b"odd!" + struct.pack("<I", 5) + b"12345\x00")
    return b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE" + chunks


def command_lines(pcm, stream5: bytes) -> dict:
    """Phase 9.  Raises AssertionError on the first check that fails.
    Returns each path's kernel launches, as counted from 0 just before it
    and read just after."""
    import collections
    import contextlib
    import shutil
    import tempfile

    import numpy as np
    import torch
    from flac_tpu_torch import (EncoderConfig, cli, container,
                                decode_stream_tpu, metaflac_cli)
    from flac_tpu_torch import metadata as md
    from flac_tpu_torch import replaygain as rg
    from flac_tpu_torch.encoder import encode_file_to_flac
    from flac_tpu_torch.ref_decoder import parse_metadata
    launches = {}
    walls = {}
    n = pcm.shape[1]
    pcm_bytes = pcm.size * 2
    tmp = tempfile.TemporaryDirectory()
    rg_proc = None

    def path(name):
        return os.path.join(tmp.name, name)

    def read(name):
        with open(path(name), "rb") as f:
            return f.read()

    def write(name, data):
        with open(path(name), "wb") as f:
            f.write(data)

    def run(label, argv, tool=cli.main):
        """A command line in this process, its launches counted from 0
        just before it and read just after; prints its stdout."""
        _reset_counts()
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = tool(argv)
        torch.cuda.synchronize()
        walls[label] = time.perf_counter() - t0
        launches[label] = _counts()
        if rc != 0:
            raise AssertionError(f"{argv} returned {rc}")
        return out.getvalue()

    def library(samples, rate, bps, device):
        """StreamEncoder with what the tool gives it at -5."""
        table = md.SeekTableBlock(points=md.SeekTableBlock.template_spaced(
            samples.shape[1], rate, 10.0).points)
        return encode_file_to_flac(samples, EncoderConfig.from_preset(
            5, sample_rate=rate, channels=2, bits_per_sample=bps),
            padding=4096, seektable=table, device=device)

    try:
        # ---- encode from a shell, then in this process ----
        t0 = time.perf_counter()
        wav_bytes = container.write_wav(pcm, RATE, 16)
        wav_write_s = time.perf_counter() - t0
        write("t.wav", wav_bytes)
        t0 = time.perf_counter()
        container.sniff_and_read(wav_bytes)
        wav_read_s = time.perf_counter() - t0
        shell_s = _cli_process(["-5", "-s", "-o", path("shell.flac"),
                                path("t.wav")])
        write("one.flac", encode(pcm[:, :4096], 5)[0])
        start_s = _cli_process(["-t", "-s", path("one.flac")])
        run("encode_-5", ["-5", "-s", "-o", path("t.flac"), path("t.wav")])
        data = read("t.flac")
        cfg5 = EncoderConfig.from_preset(5, blocksize=4096).resolve()
        quad5 = quad_batches(cfg5, n, 64)
        t0 = time.perf_counter()
        want = library(pcm, RATE, 16, "cuda")
        torch.cuda.synchronize()
        library_s = time.perf_counter() - t0
        emit({"phase": "cli", "case": "encode -5, 180 s WAV",
              "shell_wall_s": shell_s, "process_start_s": start_s,
              "shell_mb_per_s": pcm_bytes / 1e6 / shell_s,
              "in_process_wall_s": walls["encode_-5"],
              "in_process_mb_per_s": pcm_bytes / 1e6 / walls["encode_-5"],
              "library_encode_wall_s": library_s,
              "library_encode_mb_per_s": pcm_bytes / 1e6 / library_s,
              "wav_read_s": wav_read_s, "wav_write_s": wav_write_s,
              "bytes": len(data), "launches": launches["encode_-5"],
              "quad_batches": quad5})
        if data != want or read("shell.flac") != want:
            raise AssertionError("the tool's -5 file differs from "
                                 "StreamEncoder's bytes")
        if _k123(launches["encode_-5"]) != {"pack_fields64": quad5,
                                     "rice_codes": 0, "restore": 0}:
            raise AssertionError(f"the tool's encode launched "
                                 f"{launches['encode_-5']}, expected K1 "
                                 f"{quad5} times")
        if data[parse_metadata(data, 4)[1]:] != \
                stream5[parse_metadata(stream5, 4)[1]:]:
            raise AssertionError("the tool's frames differ from the main "
                                 "path's")

        # ---- decode, test, verify ----
        batches = decode_batches(decode_stream_tpu(data,
                                                   engine="host").frames)
        run("decode", ["-d", "-s", "-o", path("back.wav"), path("t.flac")])
        run("test", ["-t", "-s", path("t.flac")])
        run("verify_encode", ["-5", "-s", "-V", "-o", path("v.flac"),
                              path("t.wav")])
        written = len(written_units(cfg5, n, 64))
        emit({"phase": "cli", "case": "decode, test, verify",
              "decode_mb_per_s": pcm_bytes / 1e6 / walls["decode"],
              "test_mb_per_s": pcm_bytes / 1e6 / walls["test"],
              "verify_encode_mb_per_s":
                  pcm_bytes / 1e6 / walls["verify_encode"],
              "decode_batches": batches, "written_units": written,
              "launches": {k: launches[k] for k in ("decode", "test",
                                                    "verify_encode")}})
        if read("back.wav") != read("t.wav"):
            raise AssertionError("-d did not give the WAV back")
        for label in ("decode", "test"):
            if _k123(launches[label]) != {"pack_fields64": 0,
                                          "rice_codes": batches,
                                   "restore": batches}:
                raise AssertionError(f"{label} launched {launches[label]}, "
                                     f"expected K2 and K3 {batches} times")
        if read("v.flac") != data or _k123(launches["verify_encode"]) != {
                "pack_fields64": quad5, "rice_codes": written,
                "restore": written}:
            raise AssertionError(f"-V wrote other bytes or launched "
                                 f"{launches['verify_encode']}")

        # ---- FLAC to FLAC at -8 ----
        shutil.copy(path("t.flac"), path("tagged.flac"))
        run("metaflac_set_tags", ["--set-tag=TITLE=chip smoke",
                                  "--set-tag=ARTIST=flac_tpu_torch",
                                  path("tagged.flac")], metaflac_cli.main)
        run("reencode_-8", ["-8", "-s", "-o", path("t8.flac"),
                            path("tagged.flac")])
        data8 = read("t8.flac")
        quad8 = quad_batches(EncoderConfig.from_preset(8).resolve(), n, 64)
        st8 = decode_stream_tpu(data8)
        tags8 = md.get_tags(path("t8.flac"))
        emit({"phase": "cli", "case": "re-encode FLAC -> -8",
              "mb_per_s": pcm_bytes / 1e6 / walls["reencode_-8"],
              "wall_s": walls["reencode_-8"], "bytes": len(data8),
              "bytes_-5": len(data), "ratio": len(data8) / pcm_bytes,
              "ratio_-5": len(data) / pcm_bytes,
              "launches": launches["reencode_-8"], "quad_batches": quad8})
        if not st8.md5_ok or not np.array_equal(st8.samples, pcm) or \
                tags8.get("TITLE") != ["chip smoke"]:
            raise AssertionError("the -8 re-encode lost its audio or tags")
        if _k123(launches["reencode_-8"]) != {"pack_fields64": quad8,
                                       "rice_codes": batches,
                                       "restore": batches}:
            raise AssertionError(f"the re-encode launched "
                                 f"{launches['reencode_-8']}")

        # ---- host features on a 30 s clip ----
        clip = pcm[:, :CLIP_SECONDS * RATE]
        write("c.wav", container.write_wav(clip, RATE, 16))
        write("f.wav", _wav_with_chunks(clip))
        run("foreign_encode", ["-5", "-s", "--keep-foreign-metadata", "-o",
                               path("f.flac"), path("f.wav")])
        run("foreign_decode", ["-d", "-s", "--keep-foreign-metadata", "-o",
                               path("f2.wav"), path("f.flac")])
        if read("f2.wav") != read("f.wav"):
            raise AssertionError("--keep-foreign-metadata did not give the "
                                 "WAV back")
        run("replay_gain_encode", ["-5", "-s", "--replay-gain", "-o",
                                   path("rg.flac"), path("c.wav")])
        an = rg.GainAnalyzer(RATE)
        an.analyze_pcm(clip, 16)
        want_rg = [f"{k}={v}" for k, v in rg.format_tags(
            an.title_gain(), an.track_peak, an.album_gain(), an.album_peak)]
        got_rg = md.Chain.read(read("rg.flac")).get(
            md.VorbisCommentBlock.TYPE).comments
        if got_rg != want_rg:
            raise AssertionError(f"--replay-gain wrote {got_rg}, "
                                 f"GainAnalyzer gives {want_rg}")
        run("ogg_encode", ["-5", "-s", "--ogg", "-o", path("c.oga"),
                           path("c.wav")])
        run("ogg_decode", ["-d", "-s", "-o", path("c2.wav"), path("c.oga")])
        if read("c2.wav") != read("c.wav"):
            raise AssertionError("--ogg then -d did not give the WAV back")
        run("skip_until_encode", ["-5", "-s", "--skip", "0:05", "--until",
                                  f"+{5 * RATE}", "-o", path("cut.flac"),
                                  path("c.wav")])
        cut = decode_stream_tpu(read("cut.flac"))
        run("skip_until_decode", ["-d", "-s", "--skip", f"{11 * RATE + 7}",
                                  "--until", "+1000", "-o", path("cut.wav"),
                                  path("rg.flac")])
        cut_wav = container.read_wav(read("cut.wav")).samples
        if not cut.md5_ok or not np.array_equal(
                cut.samples, clip[:, 5 * RATE:10 * RATE]) or \
                not np.array_equal(cut_wav,
                                   clip[:, 11 * RATE + 7:11 * RATE + 1007]):
            raise AssertionError("--skip/--until cut the wrong samples")
        listing = run("metaflac_list", ["--list", path("rg.flac")],
                      metaflac_cli.main)
        if "METADATA block #0" not in listing:
            raise AssertionError(f"metaflac --list printed {listing!r}")
        host_cases = ("foreign_encode", "foreign_decode",
                      "replay_gain_encode", "ogg_encode", "ogg_decode",
                      "skip_until_encode", "skip_until_decode",
                      "metaflac_list")
        emit({"phase": "cli", "case": f"host features, {CLIP_SECONDS} s",
              "wall_s": {k: walls[k] for k in host_cases},
              "replay_gain": want_rg,
              "launches": {k: launches[k] for k in host_cases}})

        # ---- the 33-bit side channel ----
        hi = hires_clip()
        write("hi.wav", container.write_wav(hi, HIRES_RATE, 32))
        run("encode_33bit", ["-5", "-s", "-o", path("hi.flac"),
                             path("hi.wav")])
        hdata = read("hi.flac")
        host = decode_stream_tpu(hdata, engine="host")
        assignments = collections.Counter(f["assignment"]
                                          for f in host.frames)
        dec = {}
        for engine in ("device", "fast"):
            decode_stream_tpu(hdata, engine=engine)         # warm-up
            _reset_counts()
            t0 = time.perf_counter()
            st = decode_stream_tpu(hdata, engine=engine)
            torch.cuda.synchronize()
            dec[engine] = time.perf_counter() - t0
            launches[f"decode_33bit_{engine}"] = _counts()
            if not st.md5_ok or not np.array_equal(st.samples, hi) or \
                    not np.array_equal(st.samples, host.samples):
                raise AssertionError(f"the {engine} engine's decode of the "
                                     "33-bit clip differs")

        # metaflac --add-replay-gain decodes the 30 s clip in pure Python
        # (its reference decoder): it runs in its own process, as a user
        # runs it, once the 33-bit timings are taken, beside the CPU encode
        # that checks the 33-bit clip's size
        shutil.copy(path("f.flac"), path("m.flac"))
        t_rg = time.perf_counter()
        rg_proc = subprocess.Popen(
            [sys.executable, "-m", "flac_tpu_torch.metaflac_cli",
             "--add-replay-gain", path("m.flac")], cwd=HERE,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        t0 = time.perf_counter()
        cpu = library(hi, HIRES_RATE, 32, "cpu")
        cpu_s = time.perf_counter() - t0
        hi_bytes = hi.size * 4
        emit({"phase": "cli", "case": f"33-bit side, {HIRES_SECONDS} s "
              f"32-bit stereo at {HIRES_RATE} Hz",
              "encode_mb_per_s": hi_bytes / 1e6 / walls["encode_33bit"],
              "encode_wall_s": walls["encode_33bit"],
              "decode_mb_per_s": {k: hi_bytes / 1e6 / v
                                  for k, v in dec.items()},
              "assignments": dict(sorted(assignments.items())),
              "bytes": len(hdata), "bytes_cpu": len(cpu),
              "cpu_encode_s_beside_metaflac": cpu_s,
              "launches": {k: launches[k] for k in (
                  "encode_33bit", "decode_33bit_device",
                  "decode_33bit_fast")}})
        if launches["encode_33bit"]["pack_fields64"] != 0:
            raise AssertionError("K1 launched for a 32-bit stream")
        if not set(assignments) - {0}:
            raise AssertionError("no frame of the 33-bit clip chose a side "
                                 "channel")
        if abs(len(hdata) - len(cpu)) > 0.001 * len(cpu):
            raise AssertionError(f"the 33-bit clip is {len(hdata)} bytes on "
                                 f"the GPU, {len(cpu)} on the CPU")
        d, f = launches["decode_33bit_device"], launches["decode_33bit_fast"]
        if min(d["rice_codes"], d["restore"], f["restore"]) < 1 or \
                f["rice_codes"]:
            raise AssertionError(f"the 33-bit decodes launched {d}, {f}")

        _, err = rg_proc.communicate(timeout=900)
        rg_wall = time.perf_counter() - t_rg
        if rg_proc.returncode != 0:
            raise AssertionError(f"metaflac --add-replay-gain exited "
                                 f"{rg_proc.returncode}: {err[-3000:]}")
        exported = run("metaflac_export_tags", ["--export-tags-to=-",
                                                path("m.flac")],
                       metaflac_cli.main)
        emit({"phase": "cli", "case": "metaflac --add-replay-gain, "
              f"{CLIP_SECONDS} s, its own process",
              "wall_s_beside_the_cpu_encode": rg_wall,
              "export_tags_wall_s": walls["metaflac_export_tags"],
              "tags": exported.splitlines()})
        if exported.splitlines() != want_rg:
            raise AssertionError(f"metaflac --add-replay-gain wrote "
                                 f"{exported!r}, --replay-gain {want_rg}")
    finally:
        if rg_proc is not None and rg_proc.poll() is None:
            rg_proc.kill()
            rg_proc.wait()
        tmp.cleanup()
    return launches


# ---------------------------------------------------------------------------
# phase 10: the parallel paths and the encoder's pipeline on the card
# ---------------------------------------------------------------------------

SHARD_CALL = 256             # blocks an encode_blocks_dp call
SHARD_ENTRIES = 4            # mesh entries on the one card
CORPUS_SECONDS = 30          # each of the corpus runner's three WAVs
PIPELINES = ((1, 1), (2, 3), (6, 8))     # (pipeline_depth, super_batches)

# each rank's kernel launches, counted from 0 just before its work
COUNTS = f"""
import importlib
MODS = {{name: importlib.import_module("flac_tpu_torch.ops." + mod)
        for name, mod in {KERNEL_MODULES!r}.items()}}
def reset_counts():
    for mod in MODS.values():
        mod.launches = 0
def counts():
    return {{name: mod.launches for name, mod in MODS.items()}}
"""

RANK_SCRIPT = COUNTS + """
import json, os, sys, time
import numpy as np
from flac_tpu_torch import EncoderConfig
from flac_tpu_torch.parallel import multihost
port, rank, src, out = sys.argv[1:]
rank = int(rank)
os.environ["LOCAL_RANK"] = str(rank)
multihost.init_distributed(f"localhost:{port}", 2, rank)
reset_counts()
t0 = time.perf_counter()
blob, lens, off = multihost.encode_file_ranges(
    np.load(src), EncoderConfig.from_preset(5, blocksize=4096).resolve())
wall = time.perf_counter() - t0
with open(out + ".bin", "wb") as f:
    f.write(blob)
with open(out + ".json", "w") as f:
    json.dump({"all_lens": lens.tolist(), "offset": off,
               "counts": counts(), "encode_s": wall}, f)
multihost.dist.destroy_process_group()
"""

# a corpus-runner rank: the module's __main__ entry, as `-m` runs it, then
# this rank's counts into COUNT_DIR/counts<RANK>.json
CORPUS_SCRIPT = COUNTS + """
import json, os, runpy, sys
count_dir = sys.argv[1]
sys.argv = ["flac_tpu_torch.parallel.multihost", *sys.argv[2:]]
reset_counts()
try:
    runpy.run_module("flac_tpu_torch.parallel.multihost",
                     run_name="__main__", alter_sys=True)
    rc = 0
except SystemExit as e:
    rc = e.code
with open(os.path.join(count_dir, f"counts{os.environ['RANK']}.json"),
          "w") as f:
    json.dump(counts(), f)
sys.exit(rc)
"""


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(argv, **kw):
    env = {**os.environ, "PYTHONPATH": HERE}
    return subprocess.Popen(argv, cwd=HERE, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, **kw)


def _join(procs, timeout: float) -> list:
    """Wait for every process, kill any left after `timeout` seconds;
    raises unless all exited 0.  Returns their outputs."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        raise AssertionError(f"a process exited {[p.returncode for p in procs]}"
                             f": {[o[-3000:] for o in outs]}")
    return outs


def _sum_counts(each) -> dict:
    total = dict.fromkeys(KERNEL_MODULES, 0)
    for c in each:
        for k in total:
            total[k] += c[k]
    return total


def parallel_paths(pcm, stream: bytes, expect_quad: int) -> dict:
    """Phase 10.  Raises AssertionError on the first check that fails.
    Returns each path's kernel launches, as counted from 0 just before it
    and read just after (for the spawned ranks, their own counts, summed)."""
    import tempfile

    import numpy as np
    import torch
    from flac_tpu_torch import EncoderConfig, container, native
    from flac_tpu_torch.decoder import scan_frames
    from flac_tpu_torch.encoder import encode_file_to_flac
    from flac_tpu_torch.parallel.shard import (data_mesh, decode_frames_dp,
                                               encode_blocks_dp)
    from flac_tpu_torch.ref_decoder import parse_metadata
    launches = {}
    cfg5 = EncoderConfig.from_preset(5, blocksize=4096).resolve()
    st, first = parse_metadata(stream, 4)
    frames = scan_frames(stream, st, first)
    full = [f for f in frames if f["blocksize"] == 4096]
    F = len(full)
    blocks = np.ascontiguousarray(
        pcm[:, :F * 4096].reshape(2, F, 4096).transpose(1, 0, 2))
    full_bytes = pcm.shape[0] * F * 4096 * 2
    want = stream[first:first + sum(f["size"] for f in full)]
    tmp = tempfile.TemporaryDirectory()

    try:
        # ---- sharded encode: one entry, then four on the same card ----
        runs = {}
        for label, mesh in (("1_entry", data_mesh()),
                            (f"{SHARD_ENTRIES}_entries",
                             data_mesh(["cuda:0"] * SHARD_ENTRIES))):
            # two warm passes: each shape's program is captured on its
            # second call (the ragged last call's in the second pass), so
            # the timed pass replays
            for _ in range(2):
                for lo in range(0, F, SHARD_CALL):
                    encode_blocks_dp(blocks[lo:lo + SHARD_CALL], lo, cfg5,
                                     mesh)
            _reset_counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            parts = [encode_blocks_dp(blocks[lo:lo + SHARD_CALL], lo, cfg5,
                                      mesh)
                     for lo in range(0, F, SHARD_CALL)]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches[f"sharded_encode_{label}"] = _counts()
            lens = np.concatenate([ln for _, ln in parts])
            blob = b"".join(native.gather_frames(
                w.astype(">u4").view(np.uint8).reshape(w.shape[0], -1),
                ln.astype(np.int64)) for w, ln in parts)
            runs[label] = (lens, blob)
            calls = len(parts)
            emit({"phase": "parallel", "case": f"sharded encode, {label}",
                  "frames": F, "calls": calls, "entries": len(mesh),
                  "wall_s": wall, "mb_per_s": full_bytes / 1e6 / wall,
                  "launches": launches[f"sharded_encode_{label}"],
                  "k1_launches_per_call":
                      launches[f"sharded_encode_{label}"]["pack_fields64"]
                      / calls,
                  "max_memory_allocated_mb":
                      torch.cuda.max_memory_allocated() / 1e6})
            if launches[f"sharded_encode_{label}"]["pack_fields64"] != \
                    calls * len(mesh):
                raise AssertionError(f"sharded encode over {label} launched "
                                     f"{launches[f'sharded_encode_{label}']}"
                                     f", expected K1 once an entry a call")
        (l1, b1), (l4, b4) = runs.values()
        if not np.array_equal(l1, l4) or b1 != b4:
            raise AssertionError("the sharded encode's frames depend on the "
                                 "number of mesh entries")
        if b1 != want:
            bad = [i for i, f in enumerate(full)
                   if int(l1[i]) != f["size"]][:5]
            raise AssertionError(f"the sharded encode's frames differ from "
                                 f"the main path's stream (frames {bad} "
                                 "differ in length)")

        # ---- sharded decode ----
        for n_entries, label in ((1, "1_entry"),
                                 (SHARD_ENTRIES, f"{SHARD_ENTRIES}_entries")):
            _reset_counts()
            t0 = time.perf_counter()
            out = decode_frames_dp(stream, st, full,
                                   data_mesh(["cuda:0"] * n_entries))
            wall = time.perf_counter() - t0
            c = launches[f"sharded_decode_{label}"] = _counts()
            emit({"phase": "parallel", "case": f"sharded decode, "
                  f"{n_entries} entries", "frames": F, "wall_s": wall,
                  "mb_per_s": full_bytes / 1e6 / wall, "launches": c})
            if not np.array_equal(out, pcm[:, :F * 4096]):
                raise AssertionError(f"the sharded decode over {n_entries} "
                                     "entries differs from the source")
            if _k123(c) != {"pack_fields64": 0, "rice_codes": 0,
                            "restore": n_entries}:
                raise AssertionError(f"the sharded decode over {n_entries} "
                                     f"entries launched {c}")

        # ---- two processes on the card, a gloo group ----
        src = os.path.join(tmp.name, "blocks.npy")
        np.save(src, blocks)
        port = _free_port()
        t0 = time.perf_counter()
        _join([_spawn([sys.executable, "-c", RANK_SCRIPT, str(port), str(r),
                       src, os.path.join(tmp.name, f"rank{r}")])
               for r in range(2)], timeout=600)
        ranks_wall = time.perf_counter() - t0
        ranks = []
        for r in range(2):
            with open(os.path.join(tmp.name, f"rank{r}.json")) as f:
                info = json.load(f)
            with open(os.path.join(tmp.name, f"rank{r}.bin"), "rb") as f:
                info["blob"] = f.read()
            ranks.append(info)
        spliced = bytearray(sum(len(r["blob"]) for r in ranks))
        for r in ranks:
            spliced[r["offset"]:r["offset"] + len(r["blob"])] = r["blob"]
        c = launches["two_ranks"] = _sum_counts(r["counts"] for r in ranks)
        emit({"phase": "parallel", "case": "two ranks, gloo, one card",
              "wall_s_with_process_start": ranks_wall,
              "encode_s": [r["encode_s"] for r in ranks],
              "all_lens": ranks[0]["all_lens"],
              "offsets": [r["offset"] for r in ranks],
              "launches_each": [r["counts"] for r in ranks]})
        if bytes(spliced) != b1 or ranks[0]["all_lens"] != \
                ranks[1]["all_lens"]:
            raise AssertionError("the two ranks' splice differs from the "
                                 "sharded encode's bytes")
        if min(r["counts"]["pack_fields64"] for r in ranks) < 1 or \
                c["rice_codes"] or c["restore"]:
            raise AssertionError(f"the two ranks launched "
                                 f"{[r['counts'] for r in ranks]}, expected "
                                 "K1 on each and no K2 or K3")

        # ---- the corpus runner, two ranks through torch.distributed.run --
        wavs = []
        for i in range(3):
            clip = pcm[:, i * CORPUS_SECONDS * RATE:
                       (i + 1) * CORPUS_SECONDS * RATE]
            path = os.path.join(tmp.name, f"clip{i}.wav")
            with open(path, "wb") as f:
                f.write(container.write_wav(clip, RATE, 16))
            wavs.append((path, clip))
        out_dir = os.path.join(tmp.name, "corpus")
        script = os.path.join(tmp.name, "corpus_rank.py")
        with open(script, "w") as f:
            f.write(CORPUS_SCRIPT)
        t0 = time.perf_counter()
        text, = _join([_spawn([
            sys.executable, "-m", "torch.distributed.run",
            "--nproc-per-node", "2", "--master-port", str(_free_port()),
            script, tmp.name, "-5", "-o", out_dir,
            *[p for p, _ in wavs]])], timeout=600)
        corpus_wall = time.perf_counter() - t0
        lines = sorted(ln for ln in text.splitlines()
                       if ln.startswith("[host "))
        each = []
        for r in range(2):
            with open(os.path.join(tmp.name, f"counts{r}.json")) as f:
                each.append(json.load(f))
        c = launches["corpus_runner"] = _sum_counts(each)
        clip_cfg = EncoderConfig.from_preset(
            5, sample_rate=RATE, channels=2, bits_per_sample=16).resolve()
        want_k1 = sum(quad_batches(clip_cfg, clip.shape[1], 64)
                      for _, clip in wavs)
        expect_lines = sorted(
            f"[host {i % 2}/2] {os.path.join(out_dir, f'clip{i}.flac')}: "
            f"{os.path.getsize(os.path.join(out_dir, f'clip{i}.flac'))} "
            "bytes" for i in range(3))
        emit({"phase": "parallel", "case": "corpus runner, 2 ranks, "
              f"3 x {CORPUS_SECONDS} s", "wall_s_with_process_start":
              corpus_wall, "lines": lines, "launches_each": each})
        if lines != expect_lines:
            raise AssertionError(f"the corpus runner printed {lines}, "
                                 f"expected {expect_lines}")
        if _k123(c) != {"pack_fields64": want_k1, "rice_codes": 0,
                        "restore": 0}:
            raise AssertionError(f"the corpus runner's ranks launched {each}"
                                 f", expected K1 {want_k1} times in all "
                                 "(once a quad batch) and no K2 or K3")
        for i, (path, clip) in enumerate(wavs):
            with open(os.path.join(out_dir, f"clip{i}.flac"), "rb") as f:
                got = f.read()
            if got != encode_file_to_flac(clip, clip_cfg, batch_frames=64,
                                          device="cuda"):
                raise AssertionError(f"the corpus runner's clip{i}.flac "
                                     "differs from StreamEncoder's bytes")

        # ---- the pipeline's options ----
        n = pcm.shape[1]
        units = written_units(cfg5, n, 64)
        for depth, sb in PIPELINES:
            for verify in (False, True) if (depth, sb) == PIPELINES[-1] \
                    else (False,):
                label = f"pipeline_{depth}_{sb}" + ("_verify" if verify
                                                   else "")
                _reset_counts()
                t0 = time.perf_counter()
                got, enc = encode(pcm, 5, pipeline_depth=depth,
                                  super_batches=sb, verify=verify)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                c = launches[label] = _counts()
                emit({"phase": "parallel", "case": f"pipeline_depth={depth},"
                      f" super_batches={sb}, verify={verify}",
                      "encode_wall_s": wall,
                      "encode_mb_per_s": pcm.size * 2 / 1e6 / wall,
                      "remainder_fetches": enc.remainder_fetches,
                      "misfit_frames": enc.misfit_frames,
                      "written_units": len(written_units(cfg5, n, 64, sb)),
                      "launches": c})
                if got != stream:
                    raise AssertionError(f"{label} wrote other bytes than "
                                         "phase 4")
                decodes = len(units) if verify else 0
                if _k123(c) != {"pack_fields64": expect_quad,
                                "rice_codes": decodes, "restore": decodes}:
                    raise AssertionError(f"{label} launched {c}, expected K1 "
                                         f"{expect_quad} times, K2 and K3 "
                                         f"{decodes}")
    finally:
        tmp.cleanup()
    return launches


# ---------------------------------------------------------------------------
# phase hires: the hi-res and multichannel configurations at full size
# ---------------------------------------------------------------------------

Hires = collections.namedtuple("Hires", "label rate channels bps presets "
                                        "seconds seed")
# the configurations the main path leaves out: BASELINE.json config 3
# (hi-res masters), 5.1 (film and surround archives) and mono (spoken
# word), each `seconds` of signals.make_test_signal(n, channels, bps,
# seed) encoded at each of `presets`
HIRES = (Hires("24-bit 96 kHz stereo", 96000, 2, 24, (5, 8), 180, 96),
         Hires("24-bit 48 kHz 5.1", 48000, 6, 24, (5, 8), 60, 51),
         Hires("16-bit 44.1 kHz mono", 44100, 1, 16, (5,), 60, 1))
# phase 6's shapes of them: (configuration, preset)
HIRES_TIMED = ((HIRES[0], 8), (HIRES[1], 5))
CPU_CLIP_SECONDS = 10        # each stream's first seconds, also on the CPU

# a `python -m flac_tpu_torch.cli` process (the module's __main__ through
# runpy) that then writes its kernel launches to the file sys.argv[1]
TOOL_SCRIPT = COUNTS + """
import json, runpy, sys
count_file = sys.argv[1]
sys.argv = ["flac_tpu_torch.cli", *sys.argv[2:]]
reset_counts()
try:
    runpy.run_module("flac_tpu_torch.cli", run_name="__main__",
                     alter_sys=True)
    rc = 0
except SystemExit as e:
    rc = e.code
with open(count_file, "w") as f:
    json.dump(counts(), f)
sys.exit(rc)
"""


def hires_pcm(h, n: int | None = None):
    """[channels, n] int32 samples of configuration h (its full length by
    default)."""
    from flac_tpu_torch import signals
    return signals.make_test_signal(n or h.seconds * h.rate, h.channels,
                                    h.bps, seed=h.seed)


def hires_cfg(h, level: int):
    """Configuration h's resolved EncoderConfig at -level, blocksize 4096."""
    from flac_tpu_torch import EncoderConfig
    return EncoderConfig.from_preset(
        level, blocksize=4096, sample_rate=h.rate, channels=h.channels,
        bits_per_sample=h.bps).resolve()


def _tool(argv, count_file: str) -> tuple:
    """TOOL_SCRIPT in a fresh process: (wall seconds, its launches)."""
    t0 = time.perf_counter()
    _join([_spawn([sys.executable, "-c", TOOL_SCRIPT, count_file, *argv])],
          600)
    wall = time.perf_counter() - t0
    with open(count_file) as f:
        return wall, json.load(f)


def hires_paths() -> tuple:
    """Phase hires.  Raises AssertionError on the first check that fails.
    Returns (each path's kernel launches, counted from 0 just before it
    and read just after; the streams by (label, preset); the largest
    |difference| of K2 and K3 from their plain versions on the streams'
    first batches)."""
    import hashlib
    import shutil
    import tempfile

    import numpy as np
    import torch
    from flac_tpu_torch import (EncoderConfig, container, decode_stream_tpu,
                                metadata as md)
    from flac_tpu_torch import encoder as encoder_mod
    from flac_tpu_torch.encoder import encode_file_to_flac
    launches, streams = {}, {}
    errs = {"rice_codes": 0, "restore": 0}
    real_run = encoder_mod._PROGRAMS.run
    for h in HIRES:
        pcm = hires_pcm(h)
        n = pcm.shape[1]
        pcm_bytes = pcm.size * h.bps // 8
        for level in h.presets:
            path = f"{h.label} -{level}"
            cfg = hires_cfg(h, level)
            # two warm-up encodes run each key's ops and capture it
            # (encoder._EncodePrograms); the timed encode replays
            warm = []
            for _ in range(2):
                t0 = time.perf_counter()
                encode(pcm, level, rate=h.rate, bps=h.bps)
                torch.cuda.synchronize()
                warm.append(time.perf_counter() - t0)
            calls = []

            def counting_run(name, fn, *inputs):
                calls.append(name)
                return real_run(name, fn, *inputs)
            encoder_mod._PROGRAMS.run = counting_run
            _reset_counts()
            try:
                t0 = time.perf_counter()
                stream, enc = encode(pcm, level, rate=h.rate, bps=h.bps)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                del encoder_mod._PROGRAMS.run
            c = launches[f"{path} encode"] = _counts()
            quad = quad_batches(cfg, n, 64)
            # K4, K5, K7, K8, K9, K10, K6 and K11 once an encode program
            # call (a replay here, or a safe re-encode), K12 once on the
            # stereo mid-side path, K1 once a quad-layout batch
            want = dict(dict.fromkeys(KERNEL_MODULES, len(calls)),
                        pack_fields64=quad, rice_codes=0, restore=0,
                        assign_channels=len(calls) if cfg.do_mid_side else 0)
            streams[(h.label, level)] = stream
            emit({"phase": "hires", "case": f"{path} encode",
                  "seconds_audio": h.seconds, "pcm_mb": pcm_bytes / 1e6,
                  "warm_up_s": warm, "encode_wall_s": wall,
                  "encode_mb_per_s": pcm_bytes / 1e6 / wall,
                  "compression_ratio": len(stream) / pcm_bytes,
                  "stream_bytes": len(stream),
                  "sha256": hashlib.sha256(stream).hexdigest(),
                  "encode_program_calls": len(calls),
                  "calls_by_program": dict(collections.Counter(
                      f"{nm[0]}, N={nm[2]}, {nm[3]}" for nm in calls)),
                  "quad_batches": quad, "misfit_frames": enc.misfit_frames,
                  "launches": c})
            if c != want:
                raise AssertionError(f"{path}: the encode launched {c}, "
                                     f"expected {want}")
            # every engine gives the source back with the MD5; K2 and K3
            # once a decode batch where the engine runs them
            mbps = {}
            for engine in ("device", "fast", "host"):
                decode_stream_tpu(stream, engine=engine)       # warm-up
                torch.cuda.synchronize()
                _reset_counts()
                t0 = time.perf_counter()
                st = decode_stream_tpu(stream, engine=engine,
                                       max_batch=DECODE_BATCH)
                torch.cuda.synchronize()
                mbps[engine] = pcm_bytes / 1e6 / (time.perf_counter() - t0)
                c = launches[f"{path} decode {engine}"] = _counts()
                batches = decode_batches(st.frames)
                want = dict.fromkeys(KERNEL_MODULES, 0)
                want["rice_codes"] = batches if engine == "device" else 0
                want["restore"] = batches if engine != "host" else 0
                if not st.md5_ok or not np.array_equal(st.samples, pcm):
                    raise AssertionError(f"{path}: the {engine} engine's "
                                         "decode differs from the source")
                if c != want:
                    raise AssertionError(f"{path}: the {engine} decode "
                                         f"launched {c}, expected {want}")
                del st
            emit({"phase": "hires", "case": f"{path} decode",
                  "md5": "match", "decode_mb_per_s": mbps,
                  "decode_batches": batches})
            # K2 and K3 against their plain versions on the stream's first
            # decode batch: K2 on the tile tables (narrow and wide), K3 on
            # the fast engine's parse and as int32 residuals and PCM
            [(arrays, kw)] = decode_batch_inputs(stream, first_only=True)
            cases = [("rice_codes", f"{'wide' if wide else 'narrow'}",
                      k2_compare([torch.from_numpy(a).cuda()
                                  for a in arrays], dict(kw, wide=wide)))
                     for wide in (False, True)]
            [(arrays, kw)] = restore_batch_inputs(stream, first_only=True)
            t = {k: torch.from_numpy(v).cuda() for k, v in arrays.items()}
            cases += [("restore", f"the fast engine's parse, "
                       f"{arrays['res'].dtype} residuals",
                       k3_compare(t, kw)),
                      ("restore", "int32 residuals, int32 PCM",
                       k3_compare(dict(t, res=t["res"].int()),
                                  dict(kw, out16=False)))]
            for name, label, (ok, err, *_) in cases:
                emit({"phase": "hires", "kernel": name,
                      "case": f"{path} stream, first batch, {label}",
                      "identical": ok, "max_abs_err": err})
                if not ok:
                    raise AssertionError(f"{name} differs from its plain "
                                         f"version on {path}'s first batch "
                                         f"({label})")
                errs[name] = max(errs[name], err)
            # the card's stream equals the port's CPU encode (the plain
            # versions), on the first CPU_CLIP_SECONDS
            clip = np.ascontiguousarray(pcm[:, :CPU_CLIP_SECONDS * h.rate])
            card, _ = encode(clip, level, rate=h.rate, bps=h.bps)
            t0 = time.perf_counter()
            cpu = encode_file_to_flac(clip, EncoderConfig.from_preset(
                level, blocksize=4096, sample_rate=h.rate,
                channels=h.channels, bits_per_sample=h.bps), device="cpu",
                batch_frames=64)
            emit({"phase": "hires", "case": f"{path}, {CPU_CLIP_SECONDS} s "
                  "on the card and on the CPU", "identical": card == cpu,
                  "bytes": len(card), "cpu_encode_s":
                  time.perf_counter() - t0})
            if card != cpu:
                raise AssertionError(f"{path}: the card's stream differs "
                                     "from the CPU encode's")

    # the 24-bit sources as WAV files (WAVE_FORMAT_EXTENSIBLE) through the
    # flac tool at -8, then -d, each in a fresh process
    tool = [h for h in HIRES if h.bps == 24]
    tmp = tempfile.TemporaryDirectory()
    try:
        src, out = (os.path.join(tmp.name, d) for d in ("src", "out"))
        os.makedirs(src)
        os.makedirs(out)
        wavs, wants, quad, batches = [], [], 0, 0
        for i, h in enumerate(tool):
            pcm = hires_pcm(h)
            wavs.append(container.write_wav(pcm, h.rate, h.bps))
            with open(os.path.join(src, f"{i}.wav"), "wb") as f:
                f.write(wavs[-1])
            # what the tool should write: StreamEncoder's bytes with its
            # padding and 10 s seek table
            table = md.SeekTableBlock(points=md.SeekTableBlock
                                      .template_spaced(pcm.shape[1], h.rate,
                                                       10.0).points)
            wants.append(encode_file_to_flac(pcm, hires_cfg(h, 8),
                                             padding=4096, seektable=table,
                                             device="cuda"))
            quad += quad_batches(hires_cfg(h, 8), pcm.shape[1], 64)
            batches += decode_batches(decode_stream_tpu(
                wants[-1], engine="host").frames)
        del pcm
        enc_s, c = _tool(["-8", "-s", *(os.path.join(src, f"{i}.wav")
                                        for i in range(len(tool)))],
                         os.path.join(tmp.name, "encode.json"))
        launches["the 24-bit WAVs: flac -8"] = c
        for i in range(len(tool)):
            shutil.move(os.path.join(src, f"{i}.flac"),
                        os.path.join(out, f"{i}.flac"))
            with open(os.path.join(out, f"{i}.flac"), "rb") as f:
                if f.read() != wants[i]:
                    raise AssertionError(f"the tool's -8 file of "
                                         f"{tool[i].label} differs from "
                                         "StreamEncoder's bytes")
        if c["pack_fields64"] != quad:
            raise AssertionError(f"the tool's -8 encode launched {c}, "
                                 f"expected K1 {quad} times")
        dec_s, c = _tool(["-d", "-s", *(os.path.join(out, f"{i}.flac")
                                        for i in range(len(tool)))],
                         os.path.join(tmp.name, "decode.json"))
        launches["the 24-bit WAVs: flac -d"] = c
        for i in range(len(tool)):
            with open(os.path.join(out, f"{i}.wav"), "rb") as f:
                if f.read() != wavs[i]:
                    raise AssertionError(f"-d did not give the WAV of "
                                         f"{tool[i].label} back")
        if c != dict(dict.fromkeys(KERNEL_MODULES, 0), rice_codes=batches,
                     restore=batches):
            raise AssertionError(f"the tool's -d launched {c}, expected K2 "
                                 f"and K3 {batches} times")
        wav_mb = sum(len(w) for w in wavs) / 1e6
        emit({"phase": "hires", "case": "the 24-bit WAVs through "
              "python -m flac_tpu_torch.cli -8, then -d",
              "configurations": [h.label for h in tool], "wav_mb": wav_mb,
              "encode_wall_s": enc_s, "decode_wall_s": dec_s,
              "encode_mb_per_s": wav_mb / enc_s,
              "decode_mb_per_s": wav_mb / dec_s,
              "files_equal_stream_encoder": True, "wav_round_trip": True,
              "quad_batches": quad, "decode_batches": batches,
              "launches": {k: launches[k] for k in (
                  "the 24-bit WAVs: flac -8", "the 24-bit WAVs: flac -d")}})
    finally:
        tmp.cleanup()
    return launches, streams, errs


# ---------------------------------------------------------------------------
# phase 11: the compiled encode programs on the card
# ---------------------------------------------------------------------------

# the card-only tests (marker `gpu`), run by phase 11 in a subprocess
GPU_TEST_FILES = ("tests/test_torch_pack_cuda.py",
                  "tests/test_torch_assemble_cuda.py",
                  "tests/test_torch_search_cuda.py",
                  "tests/test_torch_frontend_cuda.py",
                  "tests/test_torch_rice_cuda.py",
                  "tests/test_torch_restore.py",
                  "tests/test_torch_api_cuda.py",
                  "tests/test_torch_cli_cuda.py",
                  "tests/test_torch_parallel_cuda.py",
                  "tests/test_torch_compiled_cuda.py")


class _OpsOnly:
    """Stands in for encoder._PROGRAMS: every call op by op, the form the
    graphs are held against."""

    def run(self, name, fn, *inputs):
        return fn(*inputs)


@contextlib.contextmanager
def ops_form():
    """Run every encode op by op inside the block."""
    from flac_tpu_torch import encoder as encoder_mod
    real = encoder_mod._PROGRAMS
    encoder_mod._PROGRAMS = _OpsOnly()
    try:
        yield
    finally:
        encoder_mod._PROGRAMS = real


def program_info(progs) -> list:
    """Each captured program of an encoder._EncodePrograms: its entry
    point, input shape and dtype, capture ms, what its capture added to
    the device's graph pool (MB) and the launches of K1 and K4-K7 it
    holds."""
    out = []
    for (name, inputs), p in progs.graphs.items():
        _, shape, dtype = inputs[0]
        out.append({"program": name[0], "preset_args": str(name[2:]),
                    "shape": list(shape), "dtype": str(dtype),
                    "capture_ms": p.capture_ms,
                    "pool_growth_mb": p.pool_bytes / 1e6,
                    "kernel_launches": p.kernel_launches})
    return out


def call_times(fn, runs: int = 5, traces: int = 3) -> dict:
    """One call of `fn` on the card, after a warm call: the medians over
    `runs` calls of its host ms (the call alone: the time to queue its
    work), its wall ms (the call and a synchronize) and its event ms (CUDA
    events around it: first to last of its work on the card, gaps
    included); then, from torch.profiler over one call, the kernels it
    runs and their device ms summed (the card's busy time).  A call of
    thousands of kernels fills the launch queue, so they cannot be queued
    behind a sleep kernel as queued_device_ms does.  CUPTI now and then
    drops some or all of a trace's kernel records, so the call is traced
    `traces` times and the trace with the most kernels is kept (every
    trace's count is returned beside it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    host, wall, event = [], [], []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        fn()
        b.record()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        host.append((t1 - t0) * 1e3)
        wall.append((t2 - t0) * 1e3)
        event.append(a.elapsed_time(b))
    seen = []
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        device = [e for e in prof.key_averages()
                  if str(e.device_type).endswith("CUDA")]
        seen.append((sum(e.count for e in device),
                     sum(_device_us(e, True) for e in device) / 1e3))
    kernels_, busy = max(seen)
    return {"host_ms": statistics.median(host),
            "wall_ms": statistics.median(wall),
            "event_ms": statistics.median(event),
            "kernels": kernels_, "device_busy_ms": busy,
            "kernels_each_trace": [k for k, _ in seen]}


def compiled_encode(pcm, track_keys: dict) -> dict:
    """Phase 11.  Raises AssertionError on the first check that fails.
    Returns each path's launches of K1 and K4-K12 (K2 and K3: none),
    counted from 0 just before it and read just after."""
    import numpy as np
    import torch
    from flac_tpu_torch import EncoderConfig
    from flac_tpu_torch import encoder as encoder_mod
    from flac_tpu_torch.parallel.shard import encode_batch_sharded
    progs = encoder_mod._PROGRAMS
    progs.clear()                  # every key below: ops, capture, replay
    dev = torch.device("cuda")
    N = 4096
    F = (pcm.shape[1] - 1) // N                    # the track's full blocks
    launches = {}

    def blocks(src, lo, B, n=N, dtype=np.int16):
        return torch.from_numpy(np.ascontiguousarray(
            src[:, lo:lo + B * n].reshape(src.shape[0], B, n).transpose(
                1, 0, 2), dtype)).to(dev)

    def ops(x, first, cfg, n=N, layout="auto"):
        return encoder_mod._encode_batch_ops(
            x, encoder_mod._frame_numbers(first, x.shape[0], dev), cfg, n,
            layout, "kernel")

    def hold(label, calls, graph_fn, ops_fn, lpc=True, mid_side=True):
        """Three calls of one key, each on its own inputs: the ops, the
        capture, a replay.  Each output must equal the ops form's on the
        same inputs, and the counts of K1, K4-K12 must move by the graph's
        launches on each replay (K4, K5, K7, K8, K9 and K10 once, K6 and
        K11 once where the preset has LPC, K12 once where it has the
        mid-side search)."""
        before = set(progs.graphs)
        steps = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        for args in calls:
            k = _counts()
            got = graph_fn(*args)
            torch.cuda.synchronize()
            steps.append({name: n - k[name]
                          for name, n in _counts().items()})
            want = ops_fn(*args)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"{label}: the graph's outputs differ "
                                     f"from the ops' (call {len(steps)})")
        new = [progs.graphs[k] for k in progs.graphs if k not in before]
        if len(new) != 1:
            raise AssertionError(f"{label}: {len(new)} programs captured, "
                                 "expected one")
        held = dict.fromkeys(KERNEL_MODULES, 0)
        held.update(new[0].kernel_launches)
        once = ("assemble_fields", "frame_crc", "rice_cost",
                "candidate_residuals", "select_realize",
                "channel_candidates")
        if steps != [held] * 3 or any(held[k] != 1 for k in once) \
                or held["lpc_coeffs"] != int(lpc) \
                or held["window_autoc"] != int(lpc) \
                or held["assign_channels"] != int(mid_side):
            raise AssertionError(f"{label}: the kernels counted {steps}, "
                                 f"expected {held} a call (the graph's; "
                                 "K4, K5, K7, K8, K9 and K10 once, K6 and "
                                 "K11 once with LPC, K12 once with the "
                                 "mid-side search)")
        launches[label] = {name: sum(st[name] for st in steps)
                           for name in KERNEL_MODULES}
        emit({"phase": "compiled", "case": label, "identical": True,
              "per_call": held, "capture_ms": new[0].capture_ms,
              "pool_growth_mb": new[0].pool_bytes / 1e6,
              "peak_mb": (torch.cuda.max_memory_allocated() - base) / 1e6})

    # ---- the graphs against the ops, byte for byte ----
    cfgs = {lv: EncoderConfig.from_preset(lv, blocksize=N).resolve()
            for lv in (0, 5, 8)}
    for lv, cfg in cfgs.items():
        for B, dtype in ((64, np.int16), (256, np.int32)):
            hold(f"-{lv}, {B} frames, {np.dtype(dtype).name}",
                 [(blocks(pcm, lo * N, B, dtype=dtype), lo)
                  for lo in (0, B, 2 * B)],
                 lambda x, lo, cfg=cfg: encoder_mod.encode_batch(x, lo, cfg,
                                                                 N),
                 lambda x, lo, cfg=cfg: ops(x, lo, cfg),
                 lpc=cfg.max_lpc_order > 0, mid_side=cfg.do_mid_side)
    cfg5 = cfgs[5]
    fw = encoder_mod.default_fetch_words(N, 2, 16)
    hold("-5, the trimmed 17-frame batch",
         [(blocks(pcm, lo * N, 17), lo) for lo in (F - 17, F - 34, F - 51)],
         lambda x, lo: encoder_mod.encode_batch_trimmed(x, lo, cfg5, N, fw),
         lambda x, lo: encoder_mod._trim(ops(x, lo, cfg5), fw))
    tail = pcm.shape[1] - F * N
    fw_tail = encoder_mod.default_fetch_words(tail, 2, 16)
    hold(f"-5, the final {tail}-sample block",
         [(blocks(pcm, lo, 1, n=tail), lo // N)
          for lo in (F * N, 0, 10 * N)],
         lambda x, i: encoder_mod.encode_batch_trimmed(x, i, cfg5, tail,
                                                       fw_tail),
         lambda x, i: encoder_mod._trim(ops(x, i, cfg5, n=tail), fw_tail))
    hold("-5, safe re-encode bucket of 4, per-frame numbers",
         [(blocks(pcm, lo * N, 4, dtype=np.int32),
           torch.tensor([lo, lo + 9, lo + 3, lo + 3], device=dev)
           - torch.arange(4, device=dev)) for lo in (5, 50, 500)],
         lambda x, nums: encoder_mod.encode_batch(x, nums, cfg5, N,
                                                  layout="safe"),
         lambda x, nums: ops(x, nums, cfg5, layout="safe"))
    hi = hires_clip()
    cfg_hi = EncoderConfig.from_preset(
        5, blocksize=N, sample_rate=HIRES_RATE,
        bits_per_sample=32).resolve()
    hold(f"-5, 32-bit stereo at {HIRES_RATE} Hz (the safe layout)",
         [(blocks(hi, lo * N, 64, dtype=np.int32), lo)
          for lo in (0, 64, 640)],
         lambda x, lo: encoder_mod.encode_batch(x, lo, cfg_hi, N),
         lambda x, lo: ops(x, lo, cfg_hi))
    if launches[f"-5, 32-bit stereo at {HIRES_RATE} Hz (the safe layout)"][
            "pack_fields64"]:
        raise AssertionError("the 33-bit side's program launched K1")
    # the hires configurations' 64-frame keys (int32, as StreamEncoder
    # uploads 24 bits)
    for h, lv in ((HIRES[0], 5), (HIRES[0], 8), (HIRES[1], 5)):
        src = hires_pcm(h, 3 * 64 * N)
        cfg_h = hires_cfg(h, lv)
        hold(f"-{lv}, {h.label}, 64 frames, int32",
             [(blocks(src, lo * N, 64, dtype=np.int32), lo)
              for lo in (0, 64, 128)],
             lambda x, lo, cfg=cfg_h: encoder_mod.encode_batch(x, lo, cfg,
                                                               N),
             lambda x, lo, cfg=cfg_h: ops(x, lo, cfg),
             mid_side=cfg_h.do_mid_side)

    # four shard entries of the card: one key, every shard against the ops
    host = np.ascontiguousarray(
        pcm[:, :F * N].reshape(2, F, N).transpose(1, 0, 2))
    c = dict.fromkeys(KERNEL_MODULES, 0)
    for lo in (0, 256, 512):
        before = _counts()
        shards = encode_batch_sharded(host[lo:lo + 256], lo, cfg5, N,
                                      [dev] * SHARD_ENTRIES)
        for name, n in _counts().items():     # the shards' own launches
            c[name] += n - before[name]
        for i, pf in enumerate(shards):
            x = torch.from_numpy(host[lo + 64 * i:lo + 64 * (i + 1)]).to(dev)
            if not all(torch.equal(a, b) for a, b in
                       zip(pf, ops(x, lo + 64 * i, cfg5))):
                raise AssertionError(f"shard {i} of the batch at {lo} "
                                     "differs from the ops")
    launches["four shard entries, 3 calls"] = c
    if any(c[k] != 3 * SHARD_ENTRIES for k in KERNEL_MODULES
           if k not in ("rice_codes", "restore")):
        raise AssertionError(f"four shard entries, 3 calls: {c}, expected "
                             f"K1, K4-K12 {3 * SHARD_ENTRIES} times")
    emit({"phase": "compiled", "case": "four shard entries of one card",
          "identical": True, "launches": c})

    # ---- output lifetime: a replay's outputs outlive the next replay ----
    x, y = blocks(pcm, 0, 64), blocks(pcm, 640 * N, 64)
    first = encoder_mod.encode_batch(x, 0, cfg5, N)
    kept = [t.clone() for t in first]
    second = encoder_mod.encode_batch(y, 640, cfg5, N)
    torch.cuda.synchronize()
    want = ops(x, 0, cfg5)
    if not all(torch.equal(a, b) for a, b in zip(first, kept)) or \
            not all(torch.equal(a, b) for a, b in zip(first, want)) or \
            torch.equal(first.words, second.words):
        raise AssertionError("a replay's outputs changed under the next "
                             "replay of the key")
    emit({"phase": "compiled", "case": "output lifetime", "ok": True})

    # ---- no host sync in a warm call ----
    x17 = blocks(pcm, (F - 17) * N, 17)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        encoder_mod.encode_batch(x, 0, cfg5, N)
        encoder_mod.encode_batch_trimmed(x17, F - 17, cfg5, N, fw)
        ops(x, 0, cfg5)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    emit({"phase": "compiled", "case": "set_sync_debug_mode('error') "
          "around warm calls and the ops form", "raised": False})

    # ---- times: one call of 64 and of 256 frames at -5, and of 64 frames
    # of 24-bit 96 kHz stereo at -8, ops against replay ----
    times = {}
    h = HIRES[0]
    for label, xb, cfg_t, pcm_mb in (
            ("64_frames", blocks(pcm, 0, 64), cfg5, 64 * N * 2 * 2 / 1e6),
            ("256_frames", blocks(pcm, 0, 256, dtype=np.int32), cfg5,
             256 * N * 2 * 2 / 1e6),
            (f"64_frames_{h.label} -8", blocks(hires_pcm(h, 64 * N), 0, 64,
                                               dtype=np.int32),
             hires_cfg(h, 8), 64 * N * 2 * 3 / 1e6)):
        nums = encoder_mod._frame_numbers(0, xb.shape[0], dev)

        def replay(xb=xb, cfg_t=cfg_t):
            encoder_mod.encode_batch(xb, 0, cfg_t, N)

        def op_by_op(xb=xb, nums=nums, cfg_t=cfg_t):
            encoder_mod._encode_batch_ops(xb, nums, cfg_t, N, "auto",
                                          "kernel")
        row = {run: call_times(fn) for run, fn in (
            ("ops", op_by_op), ("replay", replay), ("replay_2", replay),
            ("ops_2", op_by_op))}
        row["pcm_mb"] = pcm_mb
        times[label] = row
    emit({"phase": "compiled", "case": "times, -5 and 24-bit -8",
          "times": times,
          "track_keys": track_keys,
          "phase_11_programs": program_info(progs),
          "graph_pool_mb": sum(p.pool_bytes for p in progs.graphs.values())
          / 1e6})

    # ---- the card-only tests ----
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-o", "addopts=",
         "-p", "no:randomly", "-q", "-m", "gpu", *GPU_TEST_FILES],
        cwd=HERE, capture_output=True, text=True, timeout=600)
    with open(os.path.join(OUT_DIR, "gpu_tests.txt"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    summary = (proc.stdout.strip().splitlines() or [""])[-1]
    emit({"phase": "compiled", "case": "card-only tests", "rc":
          proc.returncode, "summary": summary,
          "seconds": time.perf_counter() - t0})
    if proc.returncode != 0:
        raise AssertionError(f"the card-only tests failed: {summary}")
    return launches


def _device_us(event, self_only: bool) -> float:
    """A profiler event's device time in microseconds, across the
    attribute names of torch versions."""
    names = (("self_device_time_total", "self_cuda_time_total") if self_only
             else ("device_time_total", "cuda_time_total"))
    for name in names:
        if hasattr(event, name):
            return float(getattr(event, name))
    return 0.0


def profile_run(run, label: str, ranges: tuple, own: tuple,
                warm: int = 1) -> dict:
    """torch.profiler over one call of `run` (after `warm` calls): wall
    time, device busy share, host and device time of each flac.* range,
    the device time of the package's own kernels (`own`: launched through
    ctypes, so the profiler does not attribute them to a range), the
    CUDA graph launches (a replay records no range) and the top kernels.
    The full table goes to OUT_DIR."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warm):
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    # device-side entries (kernels, copies); CPU ops carry their kernels'
    # time too, and the flac.* ranges' device spans include idle gaps, so
    # only kernels and copies are summed
    kernels_ = [e for e in events if str(e.device_type).endswith("CUDA")
                and not e.key.startswith("flac.")]
    busy_us = sum(_device_us(e, True) for e in kernels_)
    # per stage: host time in the range, and the device time of the
    # kernels launched inside it
    stages = {r: {"calls": 0, "host_ms": 0.0, "device_ms": 0.0}
              for r in ranges}
    for e in prof.events():
        if e.name in stages and str(e.device_type).endswith("CPU"):
            d = stages[e.name]
            d["calls"] += 1
            d["host_ms"] += e.cpu_time_total / 1e3
            d["device_ms"] += _device_us(e, False) / 1e3
    top = sorted(kernels_, key=lambda e: -_device_us(e, True))[:8]
    sort_key = ("self_device_time_total"
                if hasattr(events[0], "self_device_time_total")
                else "self_cuda_time_total")
    with open(os.path.join(OUT_DIR, f"profile_{label}.txt"), "w") as f:
        f.write(events.table(sort_by=sort_key, row_limit=40))
    own_ms = {k: sum(_device_us(e, True) for e in kernels_ if k in e.key)
              / 1e3 for k in own}
    graph_launch = [e for e in events if e.key == "cudaGraphLaunch"]
    return {"phase": "profile", "run": label, "wall_s": wall,
            "device_busy_s": busy_us / 1e6,
            "device_busy_share": busy_us / 1e6 / wall if busy_us else
            "not measured",
            "device_kernel_launches": sum(e.count for e in kernels_),
            "graph_replays": sum(e.count for e in graph_launch),
            "graph_launch_host_ms": sum(e.cpu_time_total
                                        for e in graph_launch) / 1e3,
            "stages": stages, "own_kernels_device_ms": own_ms,
            "top_kernels_ms": {e.key[:60]: _device_us(e, True) / 1e3
                               for e in top}}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="stop after the kernel-vs-plain checks")
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is False")
    sys.path.insert(0, HERE)
    try:
        from flac_tpu_torch import (EncoderConfig, decode_stream_tpu,
                                    kernels, native, signals)
        from flac_tpu_torch.models import frame as frame_mod
        from flac_tpu_torch import decoder as decoder_mod
        from flac_tpu_torch import encoder as encoder_mod
        from flac_tpu_torch.ops import assemble_synth, autoc_cuda, \
            bitpack, frontend_synth, lpc_cuda, pack_cuda, restore_cuda, \
            rice_cuda, seal_cuda, search_synth
    except ImportError as e:
        return fail(f"the flac_tpu_torch package is not here ({e})")
    os.makedirs(OUT_DIR, exist_ok=True)
    t_start = time.perf_counter()
    dev_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": torch.cuda.device_count()}

    # ---- 1. device ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    emit({"phase": "device", "name": dev_info["kind"],
          "count": dev_info["count"], "torch": torch.__version__,
          "cuda": torch.version.cuda})
    print(smi, flush=True)

    # ---- 2. build the kernel sources together, and the native runtime;
    # run the probes ----
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    import kernel_variants
    with ThreadPoolExecutor(max_workers=2) as pool:
        host_lib = pool.submit(native.lib)
        probe_lib = pool.submit(kernel_variants.build_chain_probe)
        reports = kernels.load_all(list(KERNEL_MODULES))
        build_s = time.perf_counter() - t0
        host_lib.result()
        probe_lib = probe_lib.result()
    host_s = time.perf_counter() - t0
    pack_cuda.probe()
    rice_cuda.probe()
    with open(os.path.join(OUT_DIR, "ptxas.txt"), "w") as f:
        for lib_name, report in reports.items():
            f.write(f"== {lib_name} (parallel build {build_s:.1f} s)\n"
                    f"{report}\n")
    usage = {"pack_fields64": ptxas_usage(reports["pack_fields64"],
                                          "pack_fields64_kernel"),
             "rice_codes": ptxas_usage(reports["rice_codes"],
                                       "rice_codes_kernel"),
             "restore": ptxas_usage(reports["restore"], "restore_kernel"),
             "assemble_fields": ptxas_usage(reports["assemble_fields"],
                                            "assemble_fields_kernel"),
             "frame_crc": ptxas_usage(reports["frame_crc"],
                                      "frame_crc_kernel"),
             "lpc_coeffs": ptxas_usage(reports["lpc_coeffs"],
                                       "lpc_coeffs_kernel"),
             "rice_cost": ptxas_usage(reports["rice_cost"],
                                      "rice_cost_kernel"),
             "candidate_residuals": ptxas_usage(
                 reports["candidate_residuals"],
                 "candidate_residuals_kernel"),
             "select_realize": ptxas_usage(reports["select_realize"],
                                           "select_realize_kernel"),
             "channel_candidates": ptxas_usage(
                 reports["channel_candidates"], "channel_candidates_kernel"),
             "window_autoc": ptxas_usage(reports["window_autoc"],
                                         "window_autoc_kernel"),
             "assign_channels": ptxas_usage(reports["assign_channels"],
                                            "assign_channels_kernel")}
    # K3's dynamic shared memory (its rings), by the kernel's own count and
    # by the host mirror, for each residual width, narrow and wide
    k3_lib = restore_cuda._library()
    k3_smem = {f"{8 * rb}-bit res, {'wide' if wide else 'narrow'}":
               (k3_lib.flac_restore_smem(rb, int(wide)),
                restore_cuda.smem_bytes(rb, wide))
               for rb in (2, 4, 8) for wide in (False, True)}
    emit({"phase": "build", "nvcc_seconds": round(build_s, 2),
          "native_seconds": round(host_s, 2), "probes": ["P1", "P2"],
          "ptxas": usage,
          "restore_smem_dynamic_bytes": {k: v[0] for k, v in
                                         k3_smem.items()}})
    spills = {fn: u for per in usage.values() for fn, u in per.items()
              if u.get("spill_stores") or u.get("spill_loads")}
    if spills:
        return fail(f"kernels spill registers: {spills}")
    if len(usage["restore"]) != 2 * len(restore_cuda.ORDER_BUCKETS):
        return fail(f"K3's instantiations (narrow and wide a bucket) are "
                    f"missing: {usage['restore']}")
    if len(usage["assemble_fields"]) != 3 or len(usage["frame_crc"]) != 1:
        return fail(f"K4's three layouts or K5 are missing: "
                    f"{usage['assemble_fields']} {usage['frame_crc']}")
    if len(usage["lpc_coeffs"]) != len(lpc_cuda.TEMPLATE_ORDERS) \
            or len(usage["rice_cost"]) != 4:
        return fail(f"one of K6's order templates, or one of K7's four "
                    f"forms (RICE or RICE2, the costs batched or a warp a "
                    f"node), is missing: {usage['lpc_coeffs']} "
                    f"{usage['rice_cost']}")
    # K8: int32 x (narrow or wide fixed rows, "i32" or "f64") and int64
    # x (wide, "f64"); K9: int32 and int64 signals
    if len(usage["candidate_residuals"]) != 5 \
            or len(usage["select_realize"]) != 2:
        return fail(f"one of K8's five forms or K9's two is missing: "
                    f"{usage['candidate_residuals']} "
                    f"{usage['select_realize']}")
    # K10: int16 and int32 uploads x (mid-side, the 33-bit side, the
    # channels passing through); K11: one window and several x int32 and
    # int64 signals x lag templates 8, 12 and 32; K12: int32 and int64
    # signals
    if len(usage["channel_candidates"]) != 6 \
            or len(usage["window_autoc"]) != 4 * len(
                autoc_cuda.TEMPLATE_LAGS) \
            or len(usage["assign_channels"]) != 2:
        return fail(f"one of K10's six forms, K11's twelve or K12's two is "
                    f"missing: {usage['channel_candidates']} "
                    f"{usage['window_autoc']} {usage['assign_channels']}")
    if any(a != b or a > 232448 for a, b in k3_smem.values()):
        return fail(f"K3's dynamic shared memory differs from the host "
                    f"mirror or passes 227 KB: {k3_smem}")

    # ---- 3. each kernel against its plain version ----
    # the largest |difference| each kernel showed where it is compared
    errs = dict.fromkeys(KERNEL_MODULES, 0)

    def note(name, err):
        errs[name] = max(errs[name], err)
    for label, nz, pay, pb, W in pack_cases():
        args_gpu = [torch.from_numpy(a).cuda() for a in (nz, pay, pb)]
        kw, kt = pack_cuda.pack_fields64(*args_gpu, W)
        pw, pt = bitpack.pack_fields64(*args_gpu, W)
        torch.cuda.synchronize()
        err = int((kw - pw).abs().max()) if kw.numel() else 0
        ok = torch.equal(kw, pw) and torch.equal(kt, pt)
        emit({"phase": "kernels", "kernel": "pack_fields64", "case": label,
              "identical": ok, "max_abs_err": err})
        if not ok:
            return fail(f"K1 differs from its plain version on '{label}'")
        note("pack_fields64", err)
    clips = {f"-{lv}": encode(signals.make_test_signal(
        5 * RATE, seed=30 + lv), lv)[0] for lv in (5, 8)}
    for label, arrays, static in k2_cases(clips):
        ok, err, n_ovf = k2_compare(
            [torch.from_numpy(a).cuda() for a in arrays], static)
        staged = rice_cuda.staged_ctas(arrays[1], static["NROW"])
        emit({"phase": "kernels", "kernel": "rice_codes", "case": label,
              "lanes": len(arrays[1]), "ovf_lanes": n_ovf, **static,
              "staged_ctas": int(staged.sum()), "ctas": len(staged),
              "identical": ok, "max_abs_err": err})
        if not ok:
            return fail(f"K2 differs from its plain version on '{label}'")
        note("rice_codes", err)
    for label, arrays, static in k3_cases(clips):
        t = {k: torch.from_numpy(v).cuda() for k, v in arrays.items()}
        ok, err = k3_compare(t, static)
        emit({"phase": "kernels", "kernel": "restore", "case": label,
              "subframes": int(arrays["res"].shape[0]),
              "res": str(arrays["res"].dtype), **static,
              "identical": ok, "max_abs_err": err})
        if not ok:
            return fail(f"K3 differs from its plain version on '{label}'")
        note("restore", err)
    # K4 and K5 on the corners, K5 on the plain deposit of the plain fields
    for label, case in assemble_synth.cases():
        a4 = assemble_synth.as_inputs(case, "cuda")
        ok4, err4 = k4_compare(a4)
        fields = frame_mod.assemble_fields_plain(*a4)
        ok5, err5 = k5_compare(*plain_pack(fields, a4), fields.hdr_bytes)
        emit({"phase": "kernels", "kernel": "assemble_fields, frame_crc",
              "case": label, "frames": int(a4[1].shape[0]),
              "fields": int(fields.nzeros.shape[1]),
              "misfits": int((~fields.ok).sum()), "identical": [ok4, ok5],
              "max_abs_err": [err4, err5]})
        if not (ok4 and ok5):
            return fail(f"K4 or K5 differs from its plain version on "
                        f"'{label}': {ok4}, {ok5}")
        note("assemble_fields", err4)
        note("frame_crc", err5)
    # K5 on its own corners: against the host seal everywhere, and against
    # the plain version inside its domain
    for label, case in assemble_synth.seal_cases():
        w_c, bl_c, hb_c = assemble_synth.as_seal_inputs(case, "cuda")
        got = frame_mod.seal_frames(w_c.clone(), bl_c, hb_c)
        host = assemble_synth.seal_host(case["words"], case["byte_len"],
                                        case["hdr_bytes"])
        ok5 = bool((got.cpu().numpy() == host).all())
        err5 = int(np.abs(got.cpu().numpy() - host).max())
        if case["plain"]:
            ok5 = ok5 and torch.equal(
                got, frame_mod.seal_frames_plain(w_c, bl_c, hb_c))
        emit({"phase": "kernels", "kernel": "frame_crc", "case": label,
              "frames": int(bl_c.shape[0]), "W": int(w_c.shape[1]),
              "cluster": seal_cuda.cluster_size(int(bl_c.shape[0])),
              "against": "host and plain" if case["plain"] else "host",
              "identical": ok5, "max_abs_err": err5})
        if not ok5:
            return fail(f"K5 differs on its corner '{label}'")
        note("frame_crc", err5)

    def kernel_case(label, key, a, cfg_s):
        """One K6-K12 comparison, printed; raises if it differs."""
        ok, err = stage_compare(key, a)
        note(KERNEL_KEYS[key], err)
        shown = a[1 if key == "k12" else 0]
        emit({"phase": "kernels", "kernel": KERNEL_KEYS[key],
              "case": label, "input_shape": list(shown.shape),
              "input_dtype": str(shown.dtype),
              "config": None if cfg_s is None else {
                  k: getattr(cfg_s, k) for k in (
                      "bits_per_sample", "channels", "max_lpc_order",
                      "do_exhaustive_model_search",
                      "do_qlp_coeff_prec_search", "do_escape_coding",
                      "max_residual_partition_order")},
              "identical": ok, "max_abs_err": err})
        if not ok:
            raise AssertionError(f"K{key[1:]} differs from its plain "
                                 f"version on '{label}'")

    # K6-K12 on their corners (ops/frontend_synth.py, ops/search_synth.py)
    corners = (
        [("k10", label, frontend_synth.as_candidate_inputs(case, "cuda"))
         for label, case in frontend_synth.candidate_cases()]
        + [("k11", label, frontend_synth.as_autoc_inputs(case, "cuda"))
           for label, case in frontend_synth.autoc_cases()]
        + [("k12", label, (*frontend_synth.as_assign_inputs(case, "cuda"),
                           EncoderConfig(limit_min_bitrate=case[
                               "limit_min_bitrate"]), True))
           for label, case in frontend_synth.assign_cases()]
        + [("k6", label, search_synth.as_lpc_inputs(case, "cuda"))
           for label, case in search_synth.lpc_cases()]
        + [("k7", label, search_synth.as_rice_inputs(case, "cuda"))
           for label, case in search_synth.rice_cases()]
        + [("k8", label, search_synth.as_residual_inputs(case, "cuda"))
           for label, case in search_synth.residual_cases()]
        + [("k9", label, search_synth.as_select_inputs(case, "cuda"))
           for label, case in search_synth.select_cases()])
    try:
        for key, label, a in corners:
            kernel_case(f"corner: {label}", key, a,
                        a[-1] if key in ("k10", "k6", "k7") else None)
        del corners
        # every kernel of an encode program call (K10, K11, K6, K8, K7,
        # K9, K12, K4, K1, K5) on its inputs in the ops form of real
        # batches, each as StreamEncoder uploads it (real_batches); K10
        # on a 16-bit batch widened to int32 too; the chain K4 -> K1 -> K5
        # against plain -> plain -> plain: the frames' bytes
        for label, cfg_r, x in real_batches():
            seen = capture_ops(x, cfg_r)
            for key in (*FRONT_STAGES, *SEARCH_STAGES):
                if key in seen and (key != "k12" or seen[key][-1]):
                    kernel_case(label, key, seen.pop(key), cfg_r)
            if x.dtype == torch.int16:
                kernel_case(f"{label}, widened to int32", "k10",
                            (x.int(), cfg_r), cfg_r)
            a4 = seen["k4"]
            ok4, err4 = k4_compare(a4)
            ok5, err5 = k5_compare(*seen["k5"])
            fp = frame_mod.assemble_fields_plain(*a4)
            okp, errp = k5_compare(*plain_pack(fp, a4), fp.hdr_bytes)
            chain = {}
            if "k1" in seen:
                W = seen["k1"][3]
                fk = frame_mod.assemble_fields(*a4)
                wk, tk = pack_cuda.pack_fields64(fk.nzeros, fk.payload,
                                                 fk.pbits, W)
                wk = frame_mod.seal_frames(wk, tk // 8, fk.hdr_bytes)
                wp, tp = bitpack.pack_fields64(fp.nzeros, fp.payload,
                                               fp.pbits, W)
                wp = frame_mod.seal_frames_plain(wp, tp // 8, fp.hdr_bytes)
                torch.cuda.synchronize()
                chain = {"chain_k4_k1_k5_identical": torch.equal(wk, wp)
                         and torch.equal(tk, tp),
                         "frame_bytes": int((tk // 8).sum()), "W": W}
            emit({"phase": "kernels", "kernel": "assemble_fields, "
                  "frame_crc, pack_fields64", "case": label,
                  "frames": int(a4[1].shape[0]),
                  "channels": int(a4[1].shape[1]),
                  "fields": int(fp.nzeros.shape[1]),
                  "misfits": int((~fp.ok).sum()),
                  "identical": [ok4, ok5, okp], "max_abs_err": [err4, err5,
                                                               errp],
                  **chain})
            if not (ok4 and ok5 and okp and chain.get(
                    "chain_k4_k1_k5_identical", True)):
                raise AssertionError(f"K4, K5 or the chain K4 -> K1 -> K5 "
                                     f"differs from its plain version on "
                                     f"'{label}'")
            note("assemble_fields", err4)
            note("frame_crc", max(err5, errp))
            del seen, a4, fp
    except AssertionError as e:
        return fail(str(e))
    if args.quick:
        emit({"phase": "done", "quick": True,
              "seconds": time.perf_counter() - t_start})
        print(smi, flush=True)
        emit({"ok": True, "device": dev_info})
        return 0

    # ---- 4. the main path at full size: encode, then decode ----
    n = TRACK_SECONDS * RATE
    pcm = signals.make_test_signal(n, seed=180)
    cfg5 = EncoderConfig.from_preset(5, blocksize=4096).resolve()
    expect = quad_batches(cfg5, n, 64)
    # warm-up: the track's first encode runs each key's ops and captures
    # the 64-frame batches' program, its second captures the trimmed batch
    # and the final block (encoder._EncodePrograms); the timed encode
    # replays.  The cache starts empty, so its keys are the track's.
    encoder_mod._PROGRAMS.clear()
    torch.cuda.reset_peak_memory_stats()
    warm = []
    for _ in range(2):
        t0 = time.perf_counter()
        encode(pcm, 5)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
    track_keys = {"keys": len(encoder_mod._PROGRAMS.seen),
                  "graphs": program_info(encoder_mod._PROGRAMS),
                  "warm_up_s": warm,
                  "max_memory_allocated_mb":
                      torch.cuda.max_memory_allocated() / 1e6}
    emit({"phase": "main", "warm_up_s": warm,
          "compiled_programs": track_keys})
    if len(track_keys["graphs"]) != track_keys["keys"]:
        return fail(f"the track's second encode left keys uncaptured: "
                    f"{track_keys}")
    # every encode program call (a replay here), counted beside the
    # kernels: K4 and K5 launch once a call, K1 once a quad-layout call
    program_calls = []
    real_run = encoder_mod._PROGRAMS.run

    def counting_run(name, fn, *inputs):
        program_calls.append(name)
        return real_run(name, fn, *inputs)
    encoder_mod._PROGRAMS.run = counting_run
    _reset_counts()
    try:
        t0 = time.perf_counter()
        stream, enc = encode(pcm, 5)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        del encoder_mod._PROGRAMS.run
    main_counts = _counts()
    k1_launches = main_counts["pack_fields64"]
    k4_launches = main_counts["assemble_fields"]
    k5_launches = main_counts["frame_crc"]
    k6_launches = main_counts["lpc_coeffs"]
    k7_launches = main_counts["rice_cost"]
    k8_launches = main_counts["candidate_residuals"]
    k9_launches = main_counts["select_realize"]
    k10_launches = main_counts["channel_candidates"]
    k11_launches = main_counts["window_autoc"]
    k12_launches = main_counts["assign_channels"]
    pcm_bytes = pcm.size * 2
    enc_mbps = pcm_bytes / 1e6 / wall
    emit({"phase": "main", "preset": -5, "seconds_audio": TRACK_SECONDS,
          "pcm_mb": pcm_bytes / 1e6, "encode_wall_s": wall,
          "encode_mb_per_s": enc_mbps,
          "compression_ratio": len(stream) / pcm_bytes,
          "launches": {k: main_counts[k] for k in (
              "pack_fields64", "assemble_fields", "frame_crc", "lpc_coeffs",
              "rice_cost", "candidate_residuals", "select_realize",
              "channel_candidates", "window_autoc", "assign_channels")},
          "encode_program_calls": len(program_calls),
          "calls_by_program": dict(collections.Counter(
              f"{n[0]}, N={n[2]}, {n[3]}" for n in program_calls)),
          "quad_batches": expect, "misfit_frames": enc.misfit_frames})
    if k1_launches <= 0 or k1_launches != expect:
        return fail(f"K1 launched {k1_launches} times on the main path, "
                    f"expected one per quad-layout batch ({expect})")
    if k4_launches != len(program_calls) or k5_launches != k4_launches \
            or k4_launches <= k1_launches:
        return fail(f"K4 and K5 launched {k4_launches} and {k5_launches} "
                    f"times on the main path, expected once per encode "
                    f"program call ({len(program_calls)}: K1's {expect} "
                    "and the safe tail)")
    if k6_launches != len(program_calls) or k7_launches != k6_launches:
        return fail(f"K6 and K7 launched {k6_launches} and {k7_launches} "
                    f"times on the main path, expected once per encode "
                    f"program call ({len(program_calls)})")
    if k8_launches != len(program_calls) or k9_launches != k8_launches:
        return fail(f"K8 and K9 launched {k8_launches} and {k9_launches} "
                    f"times on the main path, expected once per encode "
                    f"program call ({len(program_calls)})")
    if not k10_launches == k11_launches == k12_launches \
            == len(program_calls):
        return fail(f"K10, K11 and K12 launched {k10_launches}, "
                    f"{k11_launches} and {k12_launches} times on the main "
                    f"path, expected once per encode program call "
                    f"({len(program_calls)})")
    t0 = time.perf_counter()
    decode_stream_tpu(stream)                                # warm-up
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    staged_before = rice_cuda.staged_ctas_count()
    rice_cuda.launches = restore_cuda.launches = 0
    t0 = time.perf_counter()
    st = decode_stream_tpu(stream, max_batch=DECODE_BATCH)
    torch.cuda.synchronize()
    dec_wall = time.perf_counter() - t0
    k2_launches = rice_cuda.launches
    k3_launches = restore_cuda.launches
    k2_staged = rice_cuda.staged_ctas_count() - staged_before
    batches = decode_batches(st.frames)
    emit({"phase": "main", "decode": "device", "warm_up_s": warm_s,
          "decode_wall_s": dec_wall,
          "decode_mb_per_s": pcm_bytes / 1e6 / dec_wall,
          "encode_mb_per_s": enc_mbps, "frames": len(st.frames),
          "launches": {"rice_codes": k2_launches, "restore": k3_launches},
          "decode_batches": batches})
    if not st.md5_ok or not np.array_equal(st.samples, pcm):
        return fail("the device decode of the main track differs from the "
                    "input")
    if k2_launches <= 0 or k2_launches != batches:
        return fail(f"K2 launched {k2_launches} times on the main path, "
                    f"expected one per decode batch ({batches})")
    if k3_launches != batches:
        return fail(f"K3 launched {k3_launches} times in the device "
                    f"engine's decode, expected one per batch ({batches})")
    # the staged CTAs of each main-path launch, by the host mirror of the
    # kernel's rule; their sum must be the kernel's own count
    per_launch = []
    for arrays, kw in decode_batch_inputs(stream):
        staged = rice_cuda.staged_ctas(arrays[1], kw["NROW"])
        per_launch.append([int(staged.sum()), len(staged)])
    emit({"phase": "main", "decode": "staging",
          "staged_ctas_per_launch": per_launch,
          "staged_ctas_counted_by_kernel": k2_staged})
    if sum(s for s, _ in per_launch) != k2_staged:
        return fail(f"K2 counted {k2_staged} staged CTAs on the main path, "
                    f"the host mirror of its rule {per_launch}")
    if any(s != n for s, n in per_launch):
        return fail(f"not every CTA of the main path's K2 launches staged: "
                    f"{per_launch}")
    t0 = time.perf_counter()
    decode_stream_tpu(stream, engine="fast")                 # warm-up
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    rice_cuda.launches = restore_cuda.launches = 0
    t0 = time.perf_counter()
    fast = decode_stream_tpu(stream, engine="fast", max_batch=DECODE_BATCH)
    torch.cuda.synchronize()
    fast_wall = time.perf_counter() - t0
    k3_fast_launches = restore_cuda.launches
    emit({"phase": "main", "decode": "fast", "warm_up_s": warm_s,
          "decode_wall_s": fast_wall,
          "decode_mb_per_s": pcm_bytes / 1e6 / fast_wall,
          "launches": {"rice_codes": rice_cuda.launches,
                       "restore": k3_fast_launches},
          "decode_batches": batches})
    if not fast.md5_ok or not np.array_equal(fast.samples, pcm):
        return fail("the fast engine's decode of the main track differs "
                    "from the input")
    if k3_fast_launches != batches or rice_cuda.launches:
        return fail(f"the fast engine launched K3 {k3_fast_launches} times "
                    f"(expected {batches}) and K2 {rice_cuda.launches} "
                    "times (expected 0)")
    decode_stream_tpu(stream, engine="host")                 # warm-up
    t0 = time.perf_counter()
    host = decode_stream_tpu(stream, engine="host")
    host_s = time.perf_counter() - t0
    if not np.array_equal(host.samples, st.samples):
        return fail("the host engine's decode differs from the device's")
    # the track at -8 too (BASELINE.json config 2); both streams go to
    # OUT_DIR, where flac_tpu's decoders and encoder can be held against
    # them on a machine that has JAX
    stream8, _ = encode(pcm, 8)
    st8 = decode_stream_tpu(stream8, engine="host")
    if not st8.md5_ok or not np.array_equal(st8.samples, pcm):
        return fail("the -8 encode of the track does not decode back")
    for level, data in ((5, stream), (8, stream8)):
        with open(os.path.join(OUT_DIR, f"track_-{level}.flac"), "wb") as f:
            f.write(data)
    import hashlib
    emit({"phase": "main", "preset": -8, "stream_bytes": len(stream8),
          "stream_bytes_-5": len(stream),
          "compression_ratio": len(stream8) / pcm_bytes,
          "saved": ["track_-5.flac", "track_-8.flac"],
          "sha256": {f"track_-{level}.flac": hashlib.sha256(data).hexdigest()
                     for level, data in ((5, stream), (8, stream8))}})
    cores = os.cpu_count() or 1
    link = decoder_mod.probe_link_bandwidth("cuda")
    emit({"phase": "main", "round_trip": "ok", "md5": "match",
          "host_engine": "equal", "host_decode_s": host_s,
          "decode_mb_per_s": {"device": pcm_bytes / 1e6 / dec_wall,
                              "fast": pcm_bytes / 1e6 / fast_wall,
                              "host": pcm_bytes / 1e6 / host_s},
          "cpu_count": cores,
          "host_mb_per_s_per_core": pcm_bytes / 1e6 / host_s
          / min(cores, 8),
          "link_mb_per_s": link,
          "auto_picks": decoder_mod._pick_engine(st.frames,
                                                 torch.device("cuda"))})

    # ---- 5. A/B through the path ----
    clip = signals.make_test_signal(20 * RATE, seed=20)
    s_kernel, _ = encode(clip, 5)
    s_plain, _ = encode(clip, 5, packer="plain")
    if s_kernel != s_plain:
        return fail("-5 stream through the plain packer differs from the "
                    "kernel's")
    emit({"phase": "ab", "case": "-5 kernel vs plain", "identical": True,
          "bytes": len(s_kernel)})
    ref_s = round_trip(s_kernel, clip)
    emit({"phase": "ab", "case": "-5 round trip", "ok": True,
          "reference_decode_s": ref_s,
          "device_decode_s": device_round_trip(s_kernel, clip)})
    for level in (0, 8):
        s, _ = encode(clip, level)
        ref_s = round_trip(s, clip)
        emit({"phase": "ab", "case": f"-{level} round trip", "ok": True,
              "bytes": len(s), "reference_decode_s": ref_s,
              "device_decode_s": device_round_trip(s, clip)})
    burst = signals.make_transient_signal(20 * RATE, seed=21)
    s, benc = encode(burst, 5)
    ref_s = round_trip(s, burst)
    emit({"phase": "ab", "case": "transient clip round trip", "ok": True,
          "misfit_frames_safe_reencoded": benc.misfit_frames,
          "reference_decode_s": ref_s,
          "device_decode_s": device_round_trip(s, burst)})
    if benc.misfit_frames <= 0:
        return fail("the transient clip sent no frame to the safe re-encode")
    # tolerant decoding on the GPU: a corrupted and a cut frame
    frames = decode_stream_tpu(s_kernel, engine="host").frames
    bad = bytearray(s_kernel)
    f3, f7 = frames[3], frames[7]
    bad[f3["offset"] + f3["size"] // 2] ^= 0x10
    bad = bytes(bad[:f7["offset"] + f7["size"] // 2]
                + bad[f7["offset"] + f7["size"]:])
    want = decode_stream_tpu(bad, tolerant=True, engine="host")
    for engine in ("device", "fast"):
        t0 = time.perf_counter()
        got = decode_stream_tpu(bad, tolerant=True, engine=engine)
        torch.cuda.synchronize()
        tol_s = time.perf_counter() - t0
        same = (np.array_equal(got.samples, want.samples)
                and got.errors == want.errors)
        emit({"phase": "ab", "case": f"tolerant decode, {engine} engine",
              "equal_to_host": same, "errors": got.errors,
              "decode_s": tol_s})
        if not same or len(got.errors) < 2:
            return fail(f"the tolerant {engine} decode differs from the "
                        "host engine's, or found too few errors")
    # the "scan" engine (plain torch ops, the oracle) on a short -0 clip
    short0 = signals.make_test_signal(RATE, seed=0)
    s0, _ = encode(short0, 0, blocksize=1152)
    t0 = time.perf_counter()
    got = decode_stream_tpu(s0, engine="scan")
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t0
    host0 = decode_stream_tpu(s0, engine="host")
    same = (got.md5_ok and np.array_equal(got.samples, host0.samples)
            and np.array_equal(got.samples, short0))
    emit({"phase": "ab", "case": "scan engine, 1 s at -0, blocksize 1152",
          "equal_to_host": same, "frames": len(got.frames),
          "decode_s": scan_s})
    if not same:
        return fail("the scan engine's decode differs from the host's")

    # ---- hires: the hi-res and multichannel configurations ----
    t0 = time.perf_counter()
    hires, hires_streams, hires_errs = hires_paths()
    check_encode_calls("hires", hires)
    for name, err in hires_errs.items():
        note(name, err)
    emit({"phase": "hires", "seconds": time.perf_counter() - t0})

    # ---- 6. times at the main path's shapes and at the hires shapes ----
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    op_cycles = lpc_cuda.op_cycles()
    probe = kernel_variants.chain_probe(probe_lib)
    cfgs = {lv: EncoderConfig.from_preset(lv, blocksize=4096).resolve()
            for lv in (5, 8)}
    # the track's first batch as StreamEncoder uploads it (int16), at -5
    # and -8; its first 256 frames (the sharded form's batch, int32) for
    # K4 and K5; the main path's first decode batch
    at = {f"-{lv}": encode_kernel_times(f"-{lv}", upload(pcm, 64), cfg,
                                        probe, op_cycles, sms)
          for lv, cfg in cfgs.items()}
    at_256 = encode_kernel_times("-5, 256 frames", upload(pcm, 256, 32),
                                 cfgs[5], probe, op_cycles, sms,
                                 keys=("k4", "k5"))
    at["-5"].update(decode_kernel_times(stream, probe))
    # the hires shapes: the plain versions over 3 calls
    at_hires = {f"{h.label} -{lv}": encode_kernel_times(
        f"{h.label} -{lv}", upload(hires_pcm(h, 64 * 4096), 64, h.bps),
        hires_cfg(h, lv), probe, op_cycles, sms, plain_runs=3)
        for h, lv in HIRES_TIMED}
    at_hires[f"{HIRES[0].label} -8"].update(decode_kernel_times(
        hires_streams[(HIRES[0].label, 8)], probe, plain_runs=1))
    for shapes in (at, at_hires, {"B256": at_256}):
        for entries in shapes.values():
            for name, entry in entries.items():
                note(name, entry["max_abs_err"])
    # the device time of an empty launch of K5's grid at B=64, launched as
    # K5 is (CTAs of 256 threads in clusters of its size, each holding its
    # shared memory): the least a launch takes
    empty_cluster = seal_cuda.cluster_size(64)
    empty_smem = max(f["smem_static_bytes"]
                     for f in usage["frame_crc"].values())
    empty_launch = kernel_device_ms(
        lambda: probe_lib.flac_empty_launch(
            64 * empty_cluster, 256, empty_cluster, empty_smem,
            torch.cuda.current_stream().cuda_stream),
        "empty_kernel")
    main_launches = dict(main_counts, rice_codes=k2_launches,
                         restore=k3_launches)
    extras = {
        "pack_fields64": {"cluster": pack_cuda.CLUSTER,
                          "smem_dynamic_bytes": pack_cuda.rank_words(
                              at["-5"]["pack_fields64"]["W"]) * 4},
        "rice_codes": {"staged_ctas_per_launch": per_launch,
                       "smem_dynamic_bytes": rice_cuda.STAGE_ROWS * 64},
        "restore": {"launches_fast_engine": k3_fast_launches},
        "assemble_fields": {"at_B256": at_256["assemble_fields"]},
        "frame_crc": {"at_B256": at_256["frame_crc"],
                      "cluster": seal_cuda.cluster_size(64),
                      "empty_launch_ms": empty_launch["ms"],
                      "empty_launch_ctas": 64 * empty_cluster,
                      "empty_launch_cluster": empty_cluster,
                      "empty_launch_smem": empty_smem}}
    kernels_line = []
    for name, mod in _wrappers().items():
        main = at["-5"][name]
        kernels_line.append({
            "name": name, "route": "cuda", "source": mod.SOURCE,
            "replaces": mod.REPLACES, "launches": main_launches[name],
            **main, "max_abs_err": errs[name],
            "library_ms": main.get("library_ms"),
            **({} if "library_call" in main
               else {"library_note": LIBRARY_NOTES[name]}),
            **({"at_-8": at["-8"][name]} if name in at["-8"] else {}),
            "at_hires": {label: entries[name]
                         for label, entries in at_hires.items()
                         if name in entries},
            **extras.get(name, {}),
            **({"design": DESIGNS[name]} if name in DESIGNS else {}),
            "ptxas": usage[name]})

    # ---- 7. where the time goes in a steady encode and decode ----
    short = signals.make_test_signal(10 * RATE, seed=7)
    encode_ranges = ("flac.candidates", "flac.search", "flac.lpc_coeffs",
                     "flac.residuals", "flac.rice", "flac.select",
                     "flac.assign", "flac.assemble", "flac.fields",
                     "flac.pack", "flac.seal")
    encode_kernels = tuple(ENCODE_KERNEL_RANGES)
    # through the compiled programs (two warm calls: the 43-frame batch
    # and the final block are captured on their second), then op by op,
    # whose ranges say where the programs' device time goes
    emit(profile_run(lambda: encode(short, 5), "encode_-5", encode_ranges,
                     encode_kernels, warm=2))
    with ops_form():
        emit({**profile_run(lambda: encode(short, 5), "encode_-5_ops",
                            encode_ranges, encode_kernels),
              "own_kernels_range": ENCODE_KERNEL_RANGES})
    # the hi-res configuration: 10 s of 24-bit 96 kHz stereo at -8
    h = HIRES[0]
    short_hi = hires_pcm(h, 10 * h.rate)
    emit(profile_run(lambda: encode(short_hi, 8, rate=h.rate, bps=h.bps),
                     "encode_24bit_96k_-8", encode_ranges, encode_kernels,
                     warm=2))
    short_stream, _ = encode(short, 5)
    emit(profile_run(lambda: decode_stream_tpu(short_stream), "decode",
                     ("flac.tile_scan", "flac.upload", "flac.codes",
                      "flac.restore", "flac.fetch"),
                     ("rice_codes_kernel", "restore_kernel")))
    emit(profile_run(lambda: decode_stream_tpu(short_stream, engine="fast"),
                     "decode_fast",
                     ("flac.parse", "flac.upload", "flac.restore",
                      "flac.fetch"), ("restore_kernel",)))

    # ---- 8-11: each path's launches, counted from 0 just before it ----
    paths = {"launches_hires": hires}
    for phase, key, run in (
            ("api", "launches_library_api",
             lambda: library_api(pcm, stream, expect)),      # 8. library API
            ("cli", "launches_cli",
             lambda: command_lines(pcm, stream)),            # 9. command lines
            ("parallel", "launches_parallel",
             lambda: parallel_paths(pcm, stream, expect)),   # 10. parallel
            ("compiled", "launches_compiled_encode",
             lambda: compiled_encode(pcm, track_keys))):     # 11. programs
        t0 = time.perf_counter()
        paths[key] = run()
        check_encode_calls(phase, paths[key])
        emit({"phase": phase, "seconds": time.perf_counter() - t0})
    for k in kernels_line:
        for key, launches in paths.items():
            k[key] = {path: c[k["name"]] for path, c in launches.items()}
    emit({"kernels": kernels_line})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": dev_info})
    return 0


if __name__ == "__main__":
    sys.exit(main())
