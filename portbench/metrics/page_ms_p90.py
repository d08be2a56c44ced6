"""page_ms_p90 (ms, host clock): the 90th percentile of the time from a
client's call to its result, over every page completed in the window. It
also reads ``page_ms_p90.s_book_dense``, the per-layer copy of the traced
run of a cell whose card is idle most of the window (its host-paced tail
is watched there, not bounded). Layer of the per-layer copy: page entry."""
import statistics


def read(rec):
    ms = rec.get("page_ms")
    if not ms or len(ms) < 10:
        return None
    return statistics.quantiles(ms, n=10)[-1]
