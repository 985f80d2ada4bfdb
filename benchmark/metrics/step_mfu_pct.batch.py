"""The whole batch call's share of the card's f32 peak: the useful AM
operations of the window's audio (each utterance at its own, unpadded
length; ``counts/roofline.py``) over the window's wall seconds times 67
TFLOP/s (TF32 off)."""

from benchmark.counts.roofline import F32_OPS_PER_S


def read(record):
    if not record.get("on_card") or "am_flops" not in record:
        return None
    return 100.0 * record["am_flops"] / (record["wall_s"] * F32_OPS_PER_S)
