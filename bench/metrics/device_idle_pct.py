"""The share of the traced window in which no kernel and no copy runs
on the card: one minus the union of their intervals over the window
(100 where nothing ran on the card)."""
LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "coldstart_GBps"


def read(run):
    if run.trace is None or run.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.window_s)
