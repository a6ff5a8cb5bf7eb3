"""Percent of its roofline the CSPN op reaches in a train step, whatever
kernels run it: the op's contract bytes (the configuration's
`cspn_bytes_per_image`, forward + backward) times the batch at the card's
HBM rate, over the device ms a step of the program's spans cspn.forward
and cspn.backward (benchmark/spans.py; the spans also hold the layout
handling around the kernels). None without device times."""

from benchmark.spans import span_ms
from benchmark.tracing import peak


def read(record: dict):
    rate = peak(record, "hbm_bytes_per_s")
    ms = span_ms(record, ("cspn.forward", "cspn.backward"))
    if rate is None or not ms:
        return None
    per_image = record["counts"]["cspn_bytes_per_image"]
    nbytes = (per_image["forward"] + per_image["backward"]) * record["batch"]
    return 100.0 * (nbytes / rate) / (ms / 1e3)
