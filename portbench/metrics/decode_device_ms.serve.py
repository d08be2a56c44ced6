"""decode_device_ms.serve (ms, device_trace): the device time of the kernels launched inside
the benchmark's span around ``decode_windows``, a page, in the traced window.
Layer: decode."""


def read(rec):
    r = rec.get("trace", {}).get("ranges", {}).get("decode_windows")
    if not r or not r["count"] or r["device_s"] <= 0:
        return None
    return r["device_s"] / r["count"] * 1e3
