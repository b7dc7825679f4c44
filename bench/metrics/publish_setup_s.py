"""Seconds the set-up spent in ``ImageService.publish`` over all of the
cell's functions (the write path: chunk, key, encrypt, upload, seal)."""
LAYER = "write path (core/publish.py)"
UNIT = "s"
SOURCE = "host_clock"
MOVES = "setup_s"


def read(run):
    return run.setup.get("publish_s")
