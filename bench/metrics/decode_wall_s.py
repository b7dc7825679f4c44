"""Mean of the stats' ``decode_wall_s`` a cold start: the decode stage's
summed tile time (host packing, copies, the verify+decrypt launches).
Cold starts that share one worker's session share its ``last_batch``,
so there it is the mean over batches the sessions recorded."""
LAYER = "decode (core/decode.py)"
UNIT = "s"
SOURCE = "program_span"
MOVES = "coldstart_GBps"


def read(run):
    xs = [r["stats"]["decode_wall_s"] for r in run.done
          if r["stats"].get("decode_wall_s") is not None]
    return sum(xs) / len(xs) if xs else None
