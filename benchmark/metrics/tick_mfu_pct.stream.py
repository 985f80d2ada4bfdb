"""The chunk AM's share of the card's f32 peak inside the tick: the useful
AM operations of the frames the ticks decoded (``counts/roofline.py``,
per output frame) over the ticks' device time times 67 TFLOP/s (TF32
off)."""

from benchmark.counts.roofline import F32_OPS_PER_S


def read(record):
    if not record.get("replay_s"):
        return None
    return 100.0 * record["frames"] * record["frame_flops"] / (record["replay_s"] * F32_OPS_PER_S)
