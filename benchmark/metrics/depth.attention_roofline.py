"""% of the H100's 989 TFLOP/s bf16 dense peak reached by the depther's
attention: its FLOPs, 4 · B · T² · D a block (q·kᵀ and the product with
v; T the patch tokens and cls, D the width) times the blocks, over the
device time of the operations launched inside the program's span
``dgtd.depther.attention`` (the SDPA calls alone), a traced batch."""

import math

from benchmark import yardstick
from benchmark.metrics._spans import device_ms


def read(run):
    if run.cell.mode != "depth":
        return None
    ms = device_ms(run, "dgtd.depther.attention")
    if not ms:
        return None
    arch, traffic = run.cell.config["architecture"], run.cell.traffic
    h, w = (int(v) for v in str(traffic["size"]).split("x"))
    tokens = math.ceil(h / arch["patch"]) * math.ceil(w / arch["patch"]) + 1
    flops = 4.0 * int(traffic["batch"]) * tokens ** 2 * arch["embed_dim"] * arch["depth"]
    return 100.0 * flops / (ms * 1e-3) / yardstick.PEAK_BF16_FLOPS
