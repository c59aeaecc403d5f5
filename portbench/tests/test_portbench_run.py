"""A whole run of the harness on the CPU at a tiny size (its look for a
card skipped): sound, it comes out correct; with the control (the input's
lowest bit dropped) and with each fault broken underneath the timed path
(a bit of the written frames flipped, half of each batch left out), it
comes out not correct.  On a card, run.py's own run of a cell."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from portbench import cells, harness

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**31 + 31337


def tiny_run(workload, fault=None, traced=False):
    cell = cells.load_cell(ROOT / "BENCHMARK.json", workload)
    cell.mix = dict(cell.mix, seconds_min=0.1, seconds_max=0.3,
                    sizes_per_round=3, pool=2)
    r = harness.run_cell(cell, SEED, 0.5, traced, t0=time.perf_counter(),
                         device="cpu", fault=fault, log=lambda s: None)
    return r, r.pop("_run")


@pytest.mark.parametrize("workload", ["cd16-5.clips", "hires24-8.albums"])
def test_a_sound_run_is_correct(workload):
    r, run = tiny_run(workload)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["metrics"]) == {"encode_MBps", "size_pct", "setup_s"}
    assert 30 < r["metrics"]["size_pct"]["value"] < 100
    assert list(r)[-1] == "checks"
    assert all(v == 0 for k, (v, _) in r["checks"].items()
               if k != "files_checked")


def test_a_traced_run_reads_its_per_layer_metrics():
    r, run = tiny_run("cd16-5.clips", traced=True)
    assert r["correct"]
    assert {"finish_pct", "ops_calls_per_file",
            "misfit_pct"} <= set(r["metrics"])
    assert r["device"]["window_s"] > 0 and run.calls


@pytest.mark.parametrize("fault", ["lsb", "flip", "half"])
def test_a_broken_run_is_not_correct(fault):
    r, run = tiny_run("cd16-5.clips", fault=fault)
    assert not r["correct"]
    assert r["checks"]["bad_samples"][0] + r["checks"]["bad_frames"][0] > 0


@pytest.mark.gpu
def test_a_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "cd16-5.clips", "--seed", str(SEED), "--seconds",
                        "2", "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"]


def test_unchecked_files_take_the_checked_files_mean_a_frame():
    import io
    import numpy as np
    from portbench import work
    parsed = {"byte_len": np.array([1000, 900, 300]),
              "channels": [{"type": np.array([3, 3, 2]),
                            "po": np.array([0, 1, 0]),
                            "has_res": np.array([True, True, True])}]}
    cell = cells.load_cell(ROOT / "BENCHMARK.json", "cd16-5.clips")
    run = harness.Run(cell, 1, harness.encoding(cell.config), 4096)
    run.parses = {0: parsed}
    mean = harness.frame_mean(run)
    assert mean["lpc_subframes"] == 2 / 3 and mean["partitions"] == 4 / 3
    assert mean["crc_bytes"] == (2200 - 6) / 3
    est = harness.estimated(mean, 6)
    assert isinstance(est, work.Parse)
    assert (est.res_subframes, est.lpc_subframes, est.partitions,
            est.crc_bytes) == (6, 4, 8, 2 * (2200 - 6))
    calls = harness.file_calls(run.enc, 4 * 4096 + 3, 4096, 64, 8,
                               lambda lo, hi: harness.estimated(mean,
                                                                hi - lo), 0)
    assert [c.B for c in calls] == [4, 1] and calls[1].N == 3
    assert calls[0].parse.res_subframes == 4


def test_the_roofline_is_left_out_where_the_model_misses_the_program():
    from portbench import work
    from portbench.metrics import encode_kernels_roofline as roofline

    class Trace:
        def kernel_launches(self, name):
            return 2

        def kernel_seconds(self, name=None):
            return {name: 1e-3}
    cell = cells.load_cell(ROOT / "BENCHMARK.json", "cd16-5.albums")
    run = harness.Run(cell, 1, harness.encoding(cell.config), 4096)
    run.trace = Trace()
    run.calls = [work.Call(64, 4096, 2, True), work.Call(1, 100, 2, False)]
    logged = []
    run.log = logged.append
    model = work.call_launches(run.enc, run.calls)
    assert model["K1"] == 1 and model["K4"] == 2 and model["K12"] == 2
    run.launches = dict(model)
    share = roofline.read(run)
    assert 0 < share < 100 and not logged
    run.launches["K1"] = 2          # the program ran K1 where the model
    assert roofline.read(run) is None and "K1" in logged[0]   # did not
