"""stream.pad_share: the share of the stream's window that the host spent
in `parallel.sharded.pad_batch` (grayscale and padding of each batch),
from the wrapper spans around it over the `run_stream` call."""


def read(rec):
    pads = rec.trace.span_seconds("pad_batch")
    window = rec.trace.span_seconds("run_stream")
    if not pads or not window:
        return None
    return sum(pads) / sum(window)
