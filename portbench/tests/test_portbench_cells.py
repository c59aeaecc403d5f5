"""Configurations, mixes and per-layer metrics are found by name: a new
one is a new file and a new entry, with no edit to the harness."""

import json
import shutil
import time
from pathlib import Path

import pytest

from portbench import cells, harness, traffic

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "BENCHMARK.json"


def test_every_cell_finds_its_parts():
    bench = json.loads(BENCH.read_text())
    for w in bench["workloads"]:
        cell = cells.load_cell(BENCH, w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.mix["name"] == w["traffic"]
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        for m in cell.per_layer:
            assert callable(cells.reader(m["name"]))
    # a metric with `workloads` reaches only its cells
    clips = cells.load_cell(BENCH, "cd16-5.clips")
    albums = cells.load_cell(BENCH, "cd16-5.albums")
    assert "file_p95_ms" in {m["name"] for m in clips.per_layer}
    assert "file_p95_ms" not in {m["name"] for m in albums.per_layer}


def test_a_new_configuration_mix_and_metric_need_no_edit(tmp_path):
    """A mono configuration with StreamEncoder options, a mix with its own
    content recipe (pauses and bursts) and warm final blocks, and a
    metric: new files and entries in a copy of the benchmark, which then
    runs the new cell whole at a tiny size on the CPU."""
    here = tmp_path / "portbench"
    shutil.copytree(ROOT / "portbench", here,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(BENCH.read_text())
    config = json.loads((here / "configs" / "cd16-5.json").read_text())
    config.update(name="mono16-5v", format={"sample_rate": 44100,
                                            "channels": 1,
                                            "bits_per_sample": 16},
                  stream_encoder={"verify": True, "batch_frames": 16})
    config["encoder"]["do_mid_side"] = False
    (here / "configs" / "mono16-5v.json").write_text(json.dumps(config))
    mix = json.loads((here / "traffic" / "clips.json").read_text())
    mix.update(name="spoken", seconds_min=0.2, seconds_max=0.5,
               sizes_per_round=3, pool=2, final_blocks="warm")
    mix["content"] = dict(mix["content"],
                          pauses={"share": 0.3, "seconds": 0.05,
                                  "floor": 0.01},
                          bursts={"per_s": 4, "level": 1.0,
                                  "decay_ms": 10})
    (here / "traffic" / "spoken.json").write_text(json.dumps(mix))
    (here / "metrics" / "files_seen.py").write_text(
        "def read(run):\n    return float(len(run.files))\n")
    bench["configs"].append({"name": "mono16-5v", "source": "x",
                             "file": "portbench/configs/mono16-5v.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "mono16-5v.spoken",
                               "config": "mono16-5v", "traffic": "spoken",
                               "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "files_seen", "unit": "files",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "encode entry",
                               "moves": "encode_MBps",
                               "workloads": ["mono16-5v.spoken"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = cells.load_cell(tmp_path / "BENCHMARK.json", "mono16-5v.spoken",
                           here=here)
    assert cell.config["format"]["channels"] == 1
    assert cell.mix["name"] == "spoken"
    assert "files_seen" in {m["name"] for m in cell.per_layer}
    assert harness.encoder_options(cell.config)["verify"] is True

    # the harness reads metrics from the copy: run it with the copy's
    # readers, as run.py in that checkout would
    real_reader = cells.reader
    cells.reader = lambda name, here=here: real_reader(name, here)
    try:
        r = harness.run_cell(cell, 2**31 + 5, 0.3, True,
                             t0=time.perf_counter(), device="cpu",
                             log=lambda s: None)
    finally:
        cells.reader = real_reader
    run = r.pop("_run")
    assert r["correct"] and r["attempted"] >= 3
    assert r["metrics"]["files_seen"]["value"] == float(len(run.files))
    assert 0 <= r["metrics"]["misfit_pct"]["value"] <= 100
    assert {f.samples % 4096 for f in run.files} <= set(
        int(t) for t in traffic.Plan(cell.mix, 44100, 4096, 1).tails[:3])


def test_a_configuration_that_states_what_does_not_run_is_refused():
    config = json.loads((ROOT / "portbench" / "configs" / "cd16-5.json")
                        .read_text())
    config["format"] = dict(config["format"], channels=1)
    with pytest.raises(RuntimeError, match="do_mid_side"):
        harness.encoder_config(config)
    config["encoder"]["do_mid_side"] = False
    config["encoder"]["do_exhaustive_model_search"] = True
    cfg = harness.encoder_config(config)
    assert cfg.channels == 1 and cfg.do_exhaustive_model_search
