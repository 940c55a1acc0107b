"""device_idle_share (%): the share of the traced window in which no
device operation of the program ran: 1 - (the union of their busy
intervals) / (the window)."""


def read(ctx):
    s = ctx.summary
    if s.window_ns <= 0 or s.ops == 0:
        return None
    return 100.0 * (1.0 - s.busy_ns / s.window_ns)
