"""device_idle.<kind> (%, device_trace): the share of the traced window in
which no kernel, copy or fill ran on the device; ``device_idle.serve`` and
``device_idle.train`` read it. Layer: device."""


def read(rec):
    t = rec.get("trace")
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return (1.0 - t["busy_s"] / t["window_s"]) * 100.0
