"""K1 (the MFCC kernel): its roofline bound at a kept call's batch shape
(``counts/roofline.py:mfcc_work``) over its device time there."""


def read(record):
    if not record.get("k1_ms"):
        return None
    return 100.0 * record["k1_bound_ms"] / record["k1_ms"]
