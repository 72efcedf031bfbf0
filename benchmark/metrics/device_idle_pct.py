"""device_idle_pct: the share of the traced stretch in which the device
ran no kernel, copy or fill (the union of their intervals), in percent."""


def read(tr):
    if tr.seconds <= 0.0:
        return None
    return 100.0 * (1.0 - tr.busy_seconds() / tr.seconds)
