"""attn_fwd_roofline.train (%, device_trace): the attention forward
kernel's share of its roofline over the launches the trace saw, the least
time a launch averaged over a step's 30 sites. Layer: attention kernels."""


def read(rec):
    t = rec.get("trace")
    if not t:
        return None
    k = [v for n, v in t["kernels"].items() if "attention_fwd_kernel" in n]
    n = sum(v["count"] for v in k)
    s = sum(v["device_s"] for v in k)
    if not n or s <= 0:
        return None
    return rec["attn_fwd_bound_s"] * n / s * 100.0
