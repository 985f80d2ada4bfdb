"""K2 (the Viterbi kernel's body for the graph): its roofline bound at a kept
call's log-probs and lengths (``counts/roofline.py:viterbi_work``) over its
device time there."""


def read(record):
    if not record.get("k2_ms"):
        return None
    return 100.0 * record["k2_bound_ms"] / record["k2_ms"]
