"""Device milliseconds of a tick's program: CUDA events around each run of
the captured body (its upload and its replay), total over the count."""


def read(record):
    if not record.get("replays"):
        return None
    return 1e3 * record["replay_s"] / record["replays"]
