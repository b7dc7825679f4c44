"""The share of the window's L2 hits rebuilt from a parity stripe: the
program's ``l2.parity_rebuilds`` counter over its ``l2.hits``, both over
the window. It is silent where the L2 served no hit, and where the
program keeps no such counter."""
LAYER = "L2 (core/cache/distributed.py, core/erasure.py)"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "coldstart_GBps"


def read(run):
    hits = run.counters.get("l2.hits", 0)
    rebuilds = run.counters.get("l2.parity_rebuilds")
    if not hits or rebuilds is None:
        return None
    return 100.0 * rebuilds / hits
