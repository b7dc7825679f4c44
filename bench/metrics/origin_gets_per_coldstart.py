"""Origin GETs a cold start in the window (the program's
``read.origin_fetches`` counter over the window, per cold start): it
guards that the cell's tier, not the origin, serves the window."""
LAYER = "fetch (core/blockdev.py)"
UNIT = "GETs"
SOURCE = "program_counter"
MOVES = "coldstart_GBps"


def read(run):
    if not run.done:
        return None
    return run.counters.get("read.origin_fetches", 0) / len(run.done)
