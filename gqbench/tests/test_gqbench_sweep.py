"""The sweep that sets a cell's clients: its knee, and one set-up driving
windows at several counts of clients on the CPU."""
import io
import json
import time

from gqbench import sweep
from gqtiny import CELLS, cell


def test_knee_is_the_fewest_clients_at_four_fifths_of_the_top_rate():
    assert sweep.knee({1: [10, 11], 4: [70, 90], 16: [95, 100], 64: [99, 98]}) == 16
    assert sweep.knee({1: [10], 4: [80], 16: [100]}) == 4
    # a count's rate is the lower of its passes
    assert sweep.knee({2: [85, 60], 8: [81, 100]}) == 8
    assert sweep.knee({1: [50, 20], 4: [100, 60]}) == 4


def test_one_set_up_drives_every_count():
    out = io.StringIO()
    k = sweep.sweep(cell(CELLS[0]), 2**31 + 5, 0.2, [1, 4], 2, "cpu", time.time(),
                    err=io.StringIO(), out=out)
    lines = [json.loads(s) for s in out.getvalue().splitlines()]
    assert [r["clients"] for r in lines[:-1]] == [1, 4, 4, 1]
    assert all(r["qps"] > 0 and r["failed"] == 0 for r in lines[:-1])
    assert lines[-1]["knee_clients"] == k and k in (1, 4)
