"""pages_per_s (pages/s, host clock): every page completed in the window,
over the whole window."""


def read(rec):
    if "page_ms" not in rec:
        return None
    return rec["pages_in_window"] / rec["window_s"]
