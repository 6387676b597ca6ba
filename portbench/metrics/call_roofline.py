"""The call's least time on the card (its kernel stages' operations over the
f32 peak or bytes over the bandwidth, the larger, summed over the stages:
``work/<entry>.py``) as a share of the device's busy time per call, in %."""


def read(t):
    if t.busy_s <= 0 or not t.least_s:
        return None
    return 100.0 * t.least_s / (t.busy_s / t.calls)
