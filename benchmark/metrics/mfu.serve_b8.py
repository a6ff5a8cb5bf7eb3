"""Percent of the card's dense bf16 peak that the window's batched
requests reach: forward FLOPs an image times the frames served a second."""

from benchmark.tracing import peak


def read(record: dict):
    flops = peak(record, "bf16_flops")
    if flops is None:
        return None
    per_image = record["counts"]["flops_per_image"]["forward"]
    return 100.0 * per_image * record["window"]["img_per_s"] / flops
