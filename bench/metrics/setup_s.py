"""The run's set-up: from the process's start (imports, CUDA, the kernel
libraries, built on a checkout's first run) through the weights, the
publishes and the tier fill to the window's start."""
LAYER = "end to end"
UNIT = "s"
SOURCE = "host_clock"
MOVES = None


def read(run):
    return run.setup.get("total_s")
