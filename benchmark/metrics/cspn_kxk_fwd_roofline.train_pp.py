"""Percent of its roofline the k x k stencils' forward reaches in a CSPN++
train step: the configuration's `cspn_kxk_bytes_per_image` forward (the
5x5 and 7x7 branches' operands once each) times the batch at the card's
HBM rate, over the device ms a step of the kernels named cspn_kxk_ that
are not the adjoint's (csrc/cspn_kxk.cu). None where none ran."""

from benchmark.tracing import device_ms, peak


def read(record: dict):
    rate = peak(record, "hbm_bytes_per_s")
    ms = device_ms(record, lambda n: "cspn_kxk_" in n
                   and "cspn_kxk_adjoint" not in n)
    if rate is None or not ms:
        return None
    nbytes = record["counts"]["cspn_kxk_bytes_per_image"]["forward"] * record[
        "batch"]
    return 100.0 * (nbytes / rate) / (ms / 1e3 / record["calls"])
