"""stream.batch_ms: the median of `run_stream`'s own `batch_done.seconds`
(copy in, match, synchronise, copy out; not the padding), from the JSONL
records of the logger the benchmark hands it, in milliseconds."""

from statistics import median


def read(rec):
    secs = [r["seconds"] for r in rec.logs if r.get("event") == "batch_done"]
    return median(secs) * 1e3 if secs else None
