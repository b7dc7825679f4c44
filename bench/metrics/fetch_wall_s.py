"""Mean of the stats' ``fetch_wall_s`` a cold start: the fetch stage's
wall time (L1, L2 and origin reads of the restore). Cold starts that
share one worker's session share its ``last_batch``, so there it is the
mean over batches the sessions recorded."""
LAYER = "fetch (core/blockdev.py)"
UNIT = "s"
SOURCE = "program_span"
MOVES = "coldstart_GBps"


def read(run):
    xs = [r["stats"]["fetch_wall_s"] for r in run.done
          if r["stats"].get("fetch_wall_s") is not None]
    return sum(xs) / len(xs) if xs else None
