"""Image bytes made ready to serve per second: the bytes of every cold
start begun in the window (restored, verified, decrypted, loaded into
the model and synchronised), over the time from the window's start to
the last one's return. Work in flight at the window's end is finished
and counted, so nothing is lost at the edge."""
LAYER = "end to end"
UNIT = "GB/s"
SOURCE = "host_clock"
MOVES = None


def read(run):
    if not run.done or run.window_s <= 0:
        return None
    return run.coldstart_bytes() / run.window_s / 1e9
