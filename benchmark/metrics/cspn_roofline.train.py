"""Percent of its roofline the CSPN op reaches in a train step: the op's
contract bytes (forward: guidance's 8 planes, blur and sparse read, the
output written; backward: grad_out, guidance, blur and sparse read,
d_guidance and d_blur written; float32, each once a call) at the card's
HBM rate, over the device time a step of the kernels named below. None
where no such kernel ran."""

from benchmark.tracing import device_ms, peak

# The CSPN's kernels in csrc/: the forward round, the adjoint's stages,
# the normalization pair.
PATTERNS = ("cspn_fwd_round", "adjoint_", "gates9")


def read(record: dict):
    rate = peak(record, "hbm_bytes_per_s")
    ms = device_ms(record, lambda n: any(p in n for p in PATTERNS))
    if rate is None or not ms:
        return None
    per_image = record["counts"]["cspn_bytes_per_image"]
    nbytes = (per_image["forward"] + per_image["backward"]) * record["batch"]
    return 100.0 * (nbytes / rate) / (ms / 1e3 / record["calls"])
