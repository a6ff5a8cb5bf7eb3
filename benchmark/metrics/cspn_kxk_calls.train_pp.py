"""The k x k stencils' forward calls a CSPN++ train step: the program's
counter cspn.kxk_calls, one a forward launch sequence (2 sizes x 4
segments; benchmark/spans.py). None where the program keeps no such
counter or took no k x k route."""

from benchmark.spans import counter


def read(record: dict):
    return counter(record, "cspn.kxk_calls")
