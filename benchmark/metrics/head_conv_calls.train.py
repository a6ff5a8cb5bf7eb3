"""Head conv calls a train step that take the port's own kernels: the
program's counter head.conv_calls, one a forward of the 3 x 3 CSPN's head.
None where the program keeps no such counter."""

from benchmark.spans import counter


def read(record: dict):
    return counter(record, "head.conv_calls")
