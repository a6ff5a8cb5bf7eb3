"""MB (1e6 bytes) a request that `predict_batch` uploads to the card: the
program's counter serve.h2d_bytes (benchmark/spans.py)."""

from benchmark.spans import counter


def read(record: dict):
    n = counter(record, "serve.h2d_bytes")
    return None if n is None else n / 1e6
