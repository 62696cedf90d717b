"""The reader of the program's garbage-collector span on a synthetic
window."""
import pytest

from portbench.harness import Window
from portbench.metrics import gc_idle_share

GC = gc_idle_share.GC


def window(gc_spans):
    """A Window of 2000 ns whose device is busy 1000-1200 and 1400-1850,
    with the host inside a step group and ``gc_spans``."""
    win = Window([], [1.0], 1.0)
    win.device = [(1000, 1100, "nvjet_mm"), (1100, 1200, "flash_fwd"),
                  (1400, 1850, "elementwise")]
    win.host = sorted([(0, 2000, "portbench.step_group"),
                       (0, 2000, "repro_torch.executor.step_group")]
                      + [(s, e, GC) for s, e in gc_spans])
    win.span = (0, 2000)
    return win


def test_gc_idle_share():
    # the collection at 1200-1300 stalls the device 100 of 2000 ns
    assert gc_idle_share.read(window([(1200, 1300)])) == pytest.approx(5.0)
    # one at 900-1050 stalls 100 more, one at 1950-2100 50 (to the end)
    win = window([(1200, 1300), (900, 1050), (1950, 2100)])
    assert gc_idle_share.read(win) == pytest.approx(100 * 250 / 2000)


def test_a_collection_while_the_device_works_stalls_nothing():
    assert gc_idle_share.read(window([(1420, 1800)])) == 0.0


def test_gc_idle_share_reads_nothing_without_a_gc_span():
    # a program that opens no collection span is a missing source, not a
    # collector that never stalled; one outside the window is none of it
    assert gc_idle_share.read(window([])) is None
    assert gc_idle_share.read(window([(2100, 2200)])) is None
