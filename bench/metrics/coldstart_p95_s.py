"""The 95th percentile, over every cold start of the window, of the
client's time in one cold start (a new worker's service included where
the mix starts one), which ends in a device synchronise. A host-paced
tail."""
import statistics

LAYER = "cold start (serve/coldstart.py)"
UNIT = "s"
SOURCE = "host_clock"
MOVES = "coldstart_GBps"


def read(run):
    times = [r["end"] - r["begin"] for r in run.done]
    if len(times) < 2:
        return times[0] if times else None
    return statistics.quantiles(times, n=20, method="inclusive")[-1]
