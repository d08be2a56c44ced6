"""attn_bwd_roofline.train (%, device_trace): the attention backward's
share of its roofline: its three kernels (the row dot, dK/dV, dQ) timed
together, a call counted by its dK/dV launch, the least time a call
averaged over a step's 30 sites. Layer: attention kernels."""


def read(rec):
    t = rec.get("trace")
    if not t:
        return None
    calls = sum(v["count"] for n, v in t["kernels"].items()
                if "attention_bwd_dkdv_kernel" in n)
    s = sum(v["device_s"] for n, v in t["kernels"].items()
            if "attention_bwd_" in n)
    if not calls or s <= 0:
        return None
    return rec["attn_bwd_bound_s"] * calls / s * 100.0
