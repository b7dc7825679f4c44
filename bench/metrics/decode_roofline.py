"""The verify+decrypt work of the window at the card's peak, as a share
of the device time of every kernel (not copies) in the traced window.
The work is counted from the cell's bytes (each distinct chunk a cold
start decodes: SHA-256 and AES-256 instructions, each byte read and
written once), not from launches or tiles, so it reads the same work
whatever kernels carry it. Nothing to read without a kernel."""
from benchkit import roofline

LAYER = "kernels (kernels/*/ops.py, csrc/*.cu)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "coldstart_GBps"


def read(run):
    if run.trace is None:
        return None
    kernel_s = run.trace.kernel_s()
    chunks = run.decoded_chunks()
    if kernel_s <= 0 or not chunks:
        return None
    cs = int(run.cell.config["deployment"]["chunk_size"])
    least, _ = roofline.least_seconds(*roofline.decode_work(chunks, cs))
    return 100.0 * least / kernel_s
