"""detector_device_ms.serve (ms, device_trace): the device time of the kernels launched inside
the benchmark's span around ``run_detector``, a page, in the traced window.
Layer: detector forward."""


def read(rec):
    r = rec.get("trace", {}).get("ranges", {}).get("run_detector")
    if not r or not r["count"] or r["device_s"] <= 0:
        return None
    return r["device_s"] / r["count"] * 1e3
