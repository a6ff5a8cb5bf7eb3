"""Device ms a train step of the train loop's own phases, the program's
spans train.input (upload, decode, sparse draw, input assembly),
train.loss, train.optimizer (gradient all-reduce, clip, lr, SGD) and
train.metrics (metric sums, loss all-reduce): each span's interval on the
device's timeline (benchmark/spans.py). None without device times."""

from benchmark.spans import span_ms

SPANS = ("train.input", "train.loss", "train.optimizer", "train.metrics")


def read(record: dict):
    return span_ms(record, SPANS)
