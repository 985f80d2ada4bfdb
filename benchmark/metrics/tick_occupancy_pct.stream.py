"""Lanes a tick decodes, as a share of its slots: the lanes ``step()``
returned, summed over the steps that decoded any, over those steps times
the slots."""


def read(record):
    if not record.get("ticks"):
        return None
    return 100.0 * record["lanes"] / (record["ticks"] * record["slots"])
