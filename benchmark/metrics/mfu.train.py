"""Percent of the card's dense bf16 peak that the window's train steps
reach: the configuration's forward + backward FLOPs an image (counted over
the plain reference) times the window's images/s."""

from benchmark.tracing import peak


def read(record: dict):
    flops = peak(record, "bf16_flops")
    if flops is None:
        return None
    per_image = record["counts"]["flops_per_image"]["train"]
    return 100.0 * per_image * record["window"]["img_per_s"] / flops
