"""Host milliseconds of a ``step()`` that decoded a lane: the benchmark's own
span around each such call (no synchronize inside), total over count."""


def read(record):
    if not record.get("ticks"):
        return None
    return 1e3 * record["step_host_s"] / record["ticks"]
