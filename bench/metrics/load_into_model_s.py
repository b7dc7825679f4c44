"""Mean seconds a cold start spends loading the restored plaintext into
the model: the stats' ``load_seconds`` minus ``restore_seconds``."""
LAYER = "cold start (serve/coldstart.py)"
UNIT = "s"
SOURCE = "program_span"
MOVES = "coldstart_GBps"


def read(run):
    xs = [r["stats"]["load_seconds"] - r["stats"]["restore_seconds"]
          for r in run.done]
    return sum(xs) / len(xs) if xs else None
