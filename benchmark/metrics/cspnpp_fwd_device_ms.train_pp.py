"""Device ms a CSPN++ train step of the context-aware CSPN's forward, its
branches and the mix: the program's span cspnpp.forward on the device's
timeline (benchmark/spans.py). None without device times."""

from benchmark.spans import span_ms


def read(record: dict):
    return span_ms(record, ("cspnpp.forward",))
