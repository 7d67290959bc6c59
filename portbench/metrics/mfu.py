"""% of the card's bf16 peak (989 TFLOP/s) that the model FLOPs of the
window's completed units make, counted from the configuration's shapes."""

from portbench.core.yardstick import H100_BF16

SOURCE = "host_clock"


def read(rec):
    if rec.units <= 0 or rec.seconds <= 0 or not rec.work.get("flops"):
        return None
    return 100.0 * rec.work["flops"] * rec.units / rec.seconds / H100_BF16
