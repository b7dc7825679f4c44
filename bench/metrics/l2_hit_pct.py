"""The share of the chunks the window's cold starts read that the L2
served: the stats' ``l2_hits`` summed, over the distinct non-zero chunks
of each cold start's image as the reference counts them. It reads 0
where the window read chunks and the L2 served none; nothing to read
only where the window read no chunk."""
LAYER = "L2 (core/cache/distributed.py, core/erasure.py)"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "coldstart_GBps"


def read(run):
    chunks = run.decoded_chunks()
    if not chunks:
        return None
    hits = sum(r["stats"].get("l2_hits") or 0 for r in run.done)
    return 100.0 * hits / chunks
