"""The call's counted f32 operations (``work/<entry>.py``) over the
unprofiled window's wall seconds per call times the f32 peak, in %."""


def read(t):
    if not t.flops or t.wall_s_per_call <= 0:
        return None
    return 100.0 * t.flops / (t.wall_s_per_call * t.peak_flops)
