"""Device ms a train step of every kernel class but the CSPN's and the
optimizer's: the encoder, decoder and heads, their layout changes,
elementwise passes and copies."""

from benchmark.tracing import device_ms, kernel_class


def read(record: dict):
    ms = device_ms(record, lambda n: kernel_class(n) not in ("cspn",
                                                             "optimizer"))
    return None if ms is None else ms / record["calls"]
