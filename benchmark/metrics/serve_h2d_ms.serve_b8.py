"""Host ms a request of `predict_batch`'s upload of its input to the card
(the program's span serve.h2d, `torch.from_numpy(x).to(device)`;
benchmark/spans.py)."""

from benchmark.spans import span_ms


def read(record: dict):
    return span_ms(record, ("serve.h2d",), "host_ms")
