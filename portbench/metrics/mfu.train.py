"""mfu.train (%, device_trace): one step's model flops (three times the
forward's dense products, 4 + 10 flops a query-key pair and head column of
attention over the unmasked keys) times the steps of the traced window,
over the window, as a share of 989 TFLOP/s. Layer: train step."""
PEAK = 989e12


def read(rec):
    t = rec.get("trace")
    if not t or not rec.get("steps") or t["window_s"] <= 0:
        return None
    return rec["steps"] * rec["step_flops"] / t["window_s"] / PEAK * 100.0
