"""The kernels' yardstick against the byte counts PERF.md records for a
64-frame batch (chip_smoke.py's arithmetic on the program's arguments)."""

import pytest

from portbench import work

CD5 = work.Encoding(2, 16, 8, 5, ("tukey(5e-1)",), True)
HIRES8 = work.Encoding(2, 24, 12, 6, ("subdivide_tukey(3)",), True)
# the 64 frames' parse: every subframe LPC with one partition
PARSE = work.Parse(res_subframes=128, lpc_subframes=128, partitions=128)


@pytest.mark.parametrize("enc, in_bytes, kernel, nbytes", [
    (CD5, 2, "K8", 29_403_648),
    (HIRES8, 4, "K8", 63_246_848),
    (CD5, 2, "K7", 26_397_696),
    (CD5, 2, "K4", 4_452_800),
    (CD5, 2, "K10", 5_244_928),
])
def test_bytes_match_the_recorded_counts(enc, in_bytes, kernel, nbytes):
    call = work.Call(64, 4096, in_bytes, True, PARSE)
    assert work.call_work(enc, call)[kernel][0] == nbytes


def test_the_configurations_counts():
    assert CD5.CH == 4 and CD5.lpc_candidates(4096) == 1
    windows, rows = HIRES8.bank(4096)
    assert (len(windows), rows) == (6, 9)
    assert HIRES8.lpc_candidates(4096) == 9
    assert CD5.fields(4096, True) == 2263
    assert CD5.quad(4096) and not CD5.quad(4095)
    assert CD5.po_limit(4000) == 5 and CD5.po_limit(4095) == 0


def test_a_window_bound_is_never_above_its_calls_bounds():
    calls = [work.Call(64, 4096, 2, True, PARSE),
             work.Call(1, 1234, 2, False, work.Parse(2, 0, 0, 2, 900, 226))]
    whole = work.window_bounds(CD5, calls)
    for k, b in whole.items():
        parts = sum(work.bound(*work.call_work(CD5, c)[k])["bound_ms"]
                    for c in calls if k in work.call_work(CD5, c))
        assert b["bound_ms"] <= parts + 1e-12


def test_k11_counts_only_the_windows_live_blocks():
    w8, _ = HIRES8.bank(4096)
    full = 6 * sum(4096 - lag for lag in range(13))
    live = work._k11_products(w8, 4096, 12)
    assert 0.5 * full < live < full
    w5, _ = CD5.bank(4096)
    assert work._k11_products(w5, 4096, 8) == sum(4096 - lag
                                                  for lag in range(9))
