"""Host ms a request of `predict_batch`'s preparation on the host (the
program's span serve.prep: uint8 to float, pads, the sparse map, the
concatenation; benchmark/spans.py)."""

from benchmark.spans import span_ms


def read(record: dict):
    return span_ms(record, ("serve.prep",), "host_ms")
