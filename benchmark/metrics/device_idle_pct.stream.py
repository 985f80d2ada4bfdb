"""The share of the window in which the card ran none of the tick's
programs: 1 - (the union of the ticks' device intervals and the host
featurizer's MFCC calls, each timed by CUDA events) / the window."""


def read(record):
    if not record.get("window_s") or record.get("busy_s") is None:
        return None
    return 100.0 * (1.0 - record["busy_s"] / record["window_s"])
