"""mfu.serve (%, device_trace): the model flops of the pages of the traced
window (the detector's convolutions on every tile, the decode's dense
products and attention over the unmasked keys for each mask-predict round
run), over the traced window, as a share of 989 TFLOP/s. Layer: whole
page."""
PEAK = 989e12


def read(rec):
    t = rec.get("trace")
    if not t or not rec.get("traced_flops") or t["window_s"] <= 0:
        return None
    return rec["traced_flops"] / t["window_s"] / PEAK * 100.0
