"""The program's own spans and counters as the per-layer metrics read them:
`cspn_monodepth_tpu_torch/utils/profiling.py:collected()` after the traced
stretch, {"spans": [{name, parent, call, host_ms, device_ms}, ...],
"counters": {name: n}}, a call being one `train_step` or `predict_batch`.

A program that keeps no spans (no `collected`) reads None, and so does a
span without the clock a metric asks for (device_ms off the card).
"""

from __future__ import annotations


def collection() -> dict | None:
    """The program's collection of the traced stretch, or None."""
    from cspn_monodepth_tpu_torch.utils import profiling

    read = getattr(profiling, "collected", None)
    return None if read is None else read()


def span_ms(record: dict, names: tuple, clock: str = "device_ms"
            ) -> float | None:
    """Summed ms a call of the spans named `names` on `clock` ("device_ms"
    or "host_ms"), or None where a name has no span or a span lacks the
    clock."""
    got = collection()
    if got is None:
        return None
    spans = [s for s in got["spans"] if s["name"] in names]
    if {s["name"] for s in spans} != set(names) or any(
            s[clock] is None for s in spans):
        return None
    return sum(s[clock] for s in spans) / record["calls"]


def counter(record: dict, name: str) -> float | None:
    """The program's counter `name` a call, or None without it."""
    got = collection()
    if got is None or name not in got["counters"]:
        return None
    return got["counters"][name] / record["calls"]
