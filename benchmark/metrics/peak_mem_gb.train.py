"""Peak device memory allocated during the window, in GB (1e9 bytes):
`max_memory_allocated` after `reset_peak_memory_stats` at its start."""


def read(record: dict):
    peak = record["window"]["peak_bytes"]
    return peak / 1e9 if peak else None
