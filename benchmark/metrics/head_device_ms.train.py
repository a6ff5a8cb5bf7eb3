"""Device ms a train step of the 3 x 3 CSPN's head conv on the port's own
kernels: the program's spans head.forward and head.backward on the
device's timeline (benchmark/spans.py). None where the program has no
such spans (a head on cuDNN) or no device times."""

from benchmark.spans import span_ms


def read(record: dict):
    return span_ms(record, ("head.forward", "head.backward"))
