"""Percent of its roofline the CSPN op reaches in a batched request,
whatever kernels run it: the op's forward contract bytes (the
configuration's `cspn_bytes_per_image`) times the batch at the card's HBM
rate, over the device ms a request of the program's span cspn.forward
(benchmark/spans.py). None without device times."""

from benchmark.spans import span_ms
from benchmark.tracing import peak


def read(record: dict):
    rate = peak(record, "hbm_bytes_per_s")
    ms = span_ms(record, ("cspn.forward",))
    if rate is None or not ms:
        return None
    nbytes = record["counts"]["cspn_bytes_per_image"]["forward"] * record[
        "batch"]
    return 100.0 * (nbytes / rate) / (ms / 1e3)
