"""The share of the profiled segment in which no operation ran on the card:
torch.profiler's kernel and copy intervals, with the MFCC (K1) and Viterbi
(K2) launches it does not see added as their launches times their device
time at a kept call's shapes."""


def read(record):
    if not record.get("window_s"):
        return None
    return 100.0 * (1.0 - record["busy_s"] / record["window_s"])
