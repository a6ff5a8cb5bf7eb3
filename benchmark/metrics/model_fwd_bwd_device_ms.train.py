"""Device ms a train step of the model's forward and backward without the
CSPN op: the program's spans train.forward + train.backward less
cspn.forward + cspn.backward, on the device's timeline
(benchmark/spans.py). None without device times."""

from benchmark.spans import span_ms


def read(record: dict):
    model = span_ms(record, ("train.forward", "train.backward"))
    cspn = span_ms(record, ("cspn.forward", "cspn.backward"))
    if model is None or cspn is None:
        return None
    return model - cspn
