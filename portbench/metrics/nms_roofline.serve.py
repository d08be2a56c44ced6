"""nms_roofline.serve (%, device_trace): the NMS kernel's share of its
roofline: the least time of the launches the trace saw (bytes over 3.35
TB/s or operations over 989 TFLOP/s, portbench/roofline.py), over their
measured time. Layer: peaks."""


def read(rec):
    t = rec.get("trace")
    if not t:
        return None
    k = [v for n, v in t["kernels"].items() if "nms_sigmoid_masked" in n]
    calls = sum(r["count"] for n, r in t["ranges"].items()
                if n.startswith("detect:"))
    n = sum(v["count"] for v in k)
    s = sum(v["device_s"] for v in k)
    if not n or not calls or s <= 0:
        return None
    return rec["nms_bound_s"] / calls * n / s * 100.0
