"""Train-mode BatchNorm calls a train step that take the port's kernels:
the program's counter bn.train_calls, one a BatchNorm2d forward in train
mode on one process (69 for the ResNet-50 UNet, 52 for the ResNet-34 one).
None where the program keeps no such counter."""

from benchmark.spans import counter


def read(record: dict):
    return counter(record, "bn.train_calls")
