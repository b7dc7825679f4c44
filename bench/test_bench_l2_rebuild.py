"""CPU test of the ``l2_rebuild_pct`` reader on a ``Run``'s counters."""
from __future__ import annotations

import pytest

from benchkit import spec
from benchkit.cell import Run


@pytest.mark.parametrize("counters, want", [
    ({"l2.hits": 720, "l2.parity_rebuilds": 576}, 80.0),
    ({"l2.hits": 8, "l2.parity_rebuilds": 0}, 0.0),
    ({"l2.hits": 0, "l2.parity_rebuilds": 0}, None),
    ({"read.origin_fetches": 3}, None),
    ({"l2.hits": 720}, None),
])
def test_l2_rebuild_pct_reads_the_window_counters(counters, want):
    """100 x rebuilds / hits; silent with no L2 hit, and where the
    program counts no rebuilds (a program without the counter)."""
    reader = spec.load_reader("l2_rebuild_pct")
    got = reader.read(Run(None, "cpu", counters=counters))
    assert got == (pytest.approx(want) if want is not None else None)
