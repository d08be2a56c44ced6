"""run_detector_ms.serve (ms, program_span): the mean host time of the benchmark's span
around ``run_detector``, a page, in the traced window. Layer: page entry."""


def read(rec):
    r = rec.get("trace", {}).get("ranges", {}).get("run_detector")
    if not r or not r["count"]:
        return None
    return r["host_s"] / r["count"] * 1e3
