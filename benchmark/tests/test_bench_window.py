"""The window opens after set-up and closes on whole passes."""
import time

import pytest

from harness import window as win


@pytest.mark.parametrize("period", [1, 3, 7])
def test_window_closes_on_whole_passes(period):
    w = win.Window("cpu", 0.05, first=4, period=period, trace=False)
    step = 0
    with pytest.raises(win.WindowClosed):
        while True:
            w.on_step(step)
            time.sleep(0.004)
            step += 1
    w.close()
    assert w.issued[0] == 4 and len(w.issued) % period == 0
    assert w.issued == list(range(4, step))
    assert w.window_s >= 0.05


def test_stop_at_stops_before_the_window():
    w = win.Window("cpu", 10.0, first=5, period=2, trace=False, stop_at=3)
    for step in range(3):
        w.on_step(step)
    with pytest.raises(win.WindowClosed):
        w.on_step(3)
    assert w.issued == [] and w.t_start is None
