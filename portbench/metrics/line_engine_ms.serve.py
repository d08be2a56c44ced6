"""line_engine_ms.serve (ms, program_span): the mean host time of the
benchmark's span around ``run_line_engine``, a page, in the traced window.
The host box filter is not in it: it runs inside ``run_detector``, and the
serving cells' assumed keymap bias leaves it no candidates on the timed
path. Layer: line engine."""


def read(rec):
    r = rec.get("trace", {}).get("ranges", {}).get("line_engine")
    if not r or not r["count"]:
        return None
    return r["host_s"] / r["count"] * 1e3
