"""Layer: the device. Share of the traced window in which no kernel, copy or fill runs on the card
(the union of their intervals in the profiler's timeline), in percent."""


def read(view):
    if view.trace.window_s <= 0 or view.trace.busy_s <= 0:
        return None
    return (1.0 - view.trace.busy_s / view.trace.window_s) * 100.0
