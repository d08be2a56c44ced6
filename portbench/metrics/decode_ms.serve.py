"""decode_ms.serve (ms, program_span): the mean host time of the benchmark's span
around ``decode_windows``, a page, in the traced window. Layer: decode."""


def read(rec):
    r = rec.get("trace", {}).get("ranges", {}).get("decode_windows")
    if not r or not r["count"]:
        return None
    return r["host_s"] / r["count"] * 1e3
