"""The port's fused detector heads against the JAX package, on the CPU:
``FusedLeafmaps``, ``CenterNetDetection(fused=True)``,
``fuse_head_variables`` / ``unfuse_head_variables`` and the weight paths
that know the fused layout (``io.from_jax``, ``model.pt`` out and in,
int8 quantization), and the fused heads' train moments over a 2-rank gloo
group.

The heads rig is ``tests/test_fused_heads.py``'s (conv_dim 16,
feature_dim 10, taps (2,16,16,6) ... (2,2,2,12)), its variables drawn with
numpy: every head's parameters and running statistics differ, and the tap
BatchNorms' running means sit near 2, far from 0, so the border-aware
folded bias is exercised at every edge pixel. The taps' own means are
near 0.7.

Tolerances: outputs and gradients rtol 2e-4 / atol 5e-4 (the JAX
package's own bound for the fused heads, ``tests/test_fused_heads.py``;
two frameworks' f32 convolutions sum in other orders), gradients against
their largest magnitude; updated running statistics atol 1e-5; weight
moves (fuse, unfuse, from_jax, export, import, quantize) bit for bit.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from torch import nn

from findtextcenternet_tpu.export import quantize as jq
from findtextcenternet_tpu.io.torch_export import (
    export_detector_sd as jexport_detector_sd)
from findtextcenternet_tpu.io.torch_import import import_detector
from findtextcenternet_tpu.models import detector as jdet
from findtextcenternet_tpu.models import efficientnet as jeff
from findtextcenternet_tpu_torch.export import quantize as tq
from findtextcenternet_tpu_torch.io.from_jax import (
    detector_state_from_flax, flax_paths)
from findtextcenternet_tpu_torch.io.torch_export import (
    export_detector_sd, save_torch_checkpoint)
from findtextcenternet_tpu_torch.io.torch_import import (
    load_torch_state_dict, split_detector_state)
from findtextcenternet_tpu_torch.models import efficientnet as teff
from findtextcenternet_tpu_torch.models.batchnorm import set_sync_group
from findtextcenternet_tpu_torch.models.detector import (
    HEAD_DIMS, HEADS, CenterNetDetection, FusedLeafmaps, Leafmap,
    fuse_head_variables, unfuse_head_variables)

D, FDIM = 16, 10
TAP_CH = (6, 8, 10, 12)
RTOL, ATOL = 2e-4, 5e-4
STAT_ATOL = 1e-5
NAMES = [j for _, j, _ in HEADS] + ["feature"]   # the JAX head names


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _draw(shapes, rng, path=()):
    """numpy values for a flax shape tree: kernels N(0, 1/fan_in), scales
    near 1, biases near 0, running means near 2 in the tap BatchNorms
    (``in_bn*``) and near 0 elsewhere, variances in [0.5, 2]."""
    if isinstance(shapes, dict):
        return {k: _draw(v, rng, path + (k,)) for k, v in shapes.items()}
    shape, leaf = shapes.shape, path[-1]
    if leaf == "kernel":
        fan = int(np.prod(shape[:-1]))
        a = rng.normal(0, 1 / np.sqrt(fan), shape)
    elif leaf == "scale":
        a = 1 + 0.3 * rng.standard_normal(shape)
    elif leaf == "bias":
        a = 0.3 * rng.standard_normal(shape)
    elif leaf == "mean":
        a = (2.0 if path[-2].startswith("in_bn") else 0.0) \
            + 0.5 * rng.standard_normal(shape)
    else:
        a = rng.uniform(0.5, 2.0, shape)
    return a.astype(np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=msg)


def _heads_state(fp, fs):
    """The port's FusedLeafmaps state from JAX's fused leaves: the same
    names and shapes, the merged BatchNorms keyed as torch's."""
    sd = {}
    for k, v in fp.items():
        if isinstance(v, dict):
            sd.update({f"{k}.weight": v["scale"], f"{k}.bias": v["bias"],
                       f"{k}.running_mean": fs[k]["mean"],
                       f"{k}.running_var": fs[k]["var"],
                       f"{k}.num_batches_tracked": np.asarray(0)})
        else:
            sd[k] = v
    sd.update({k: v for k, v in fs.items() if not isinstance(v, dict)})
    return {k: torch.tensor(np.asarray(v)) for k, v in sd.items()}


def _heads_grad_tree(heads):
    """The port heads' parameter gradients as JAX's fused tree."""
    g = {}
    for k, p in heads.named_parameters():
        if "_bn." in k:
            mod, leaf = k.split(".")
            g.setdefault(mod, {})["scale" if leaf == "weight" else
                                  "bias"] = p.grad.numpy()
        else:
            g[k] = p.grad.numpy()
    return g


@pytest.fixture(scope="module")
def rig():
    rng = np.random.default_rng(0)
    taps = [(0.7 + 1.5 * rng.standard_normal(
        (2, 16 >> i, 16 >> i, c))).astype(np.float32)
        for i, c in enumerate(TAP_CH)]
    jtaps = [jnp.asarray(t) for t in taps]
    hp, hs = {}, {}
    for n, d in zip(NAMES, list(HEAD_DIMS) + [FDIM]):
        shapes = jax.eval_shape(jdet.Leafmap(d, conv_dim=D).init,
                                jax.random.PRNGKey(0), jtaps)
        hp[n] = _draw(shapes["params"], rng)
        hs[n] = _draw(shapes["batch_stats"], rng)
    fp, fs = jdet.fuse_head_variables(hp, hs, feature_dim=FDIM, conv_dim=D)
    fused = jdet.FusedLeafmaps(tuple(HEAD_DIMS), FDIM, conv_dim=D)
    ch = rng.standard_normal((2, 16, 16, sum(HEAD_DIMS))).astype(np.float32)
    cf = rng.standard_normal((2, 16, 16, FDIM)).astype(np.float32)

    def loss(params, taps):
        (heat, feat), _ = fused.apply(
            {"params": params, "batch_stats": fs}, taps, True,
            mutable=["batch_stats"])
        return jnp.sum(heat * ch) + jnp.sum(feat * cf)

    @jax.jit
    def reference(params, taps):
        v = {"params": params, "batch_stats": fs}
        return (fused.apply(v, taps, False),
                fused.apply(v, taps, True, mutable=["batch_stats"]),
                jax.grad(loss, argnums=(0, 1))(params, taps))

    ev, (tr, mut), (gp, gt) = jax.tree_util.tree_map(
        np.asarray, reference(fp, jtaps))
    return {"taps": taps, "hp": hp, "hs": hs, "fp": fp, "fs": fs,
            "ch": ch, "cf": cf, "eval": ev, "train": tr,
            "stats": mut["batch_stats"], "grad_params": gp,
            "grad_taps": gt}


def _heads(rig):
    m = FusedLeafmaps(TAP_CH, HEAD_DIMS, FDIM, D)
    m.load_state_dict(_heads_state(rig["fp"], rig["fs"]))
    return m


class PerHead(nn.Module):
    """The per-head Leafmaps of a CenterNetDetection, keyed as its."""

    def __init__(self):
        super().__init__()
        for name, _, dim in HEADS:
            setattr(self, name, Leafmap(TAP_CH, dim, D))
        self.feature = Leafmap(TAP_CH, FDIM, D)

    def forward(self, taps):
        return (torch.cat([getattr(self, n)(taps) for n, _, _ in HEADS], 1),
                self.feature(taps))


def _wrapped(heads):
    """A state dict of ``heads`` keyed as a fused CenterNetDetection's."""
    return {f"heads.{k}": v for k, v in heads.state_dict().items()}


def test_eval_matches_jax(rig):
    m = _heads(rig).eval()
    with torch.no_grad():
        heat, feat = m([_nchw(t) for t in rig["taps"]])
    _close(_nhwc(heat), rig["eval"][0])
    _close(_nhwc(feat), rig["eval"][1])


def test_train_and_running_stats_match_jax(rig):
    m = _heads(rig).train()
    with torch.no_grad():
        heat, feat = m([_nchw(t) for t in rig["taps"]])
    _close(_nhwc(heat), rig["train"][0])
    _close(_nhwc(feat), rig["train"][1])
    st = rig["stats"]
    for level in range(4):
        for leaf in ("mean", "var"):
            _close(getattr(m, f"in_bn{level}_{leaf}").numpy(),
                   st[f"in_bn{level}_{leaf}"], 0, STAT_ATOL)
    for i in range(4):
        bn = getattr(m, f"up{i}_bn")
        _close(bn.running_mean.numpy(), st[f"up{i}_bn"]["mean"], 0,
               STAT_ATOL)
        _close(bn.running_var.numpy(), st[f"up{i}_bn"]["var"], 0,
               STAT_ATOL)


def test_gradients_match_jax(rig):
    m = _heads(rig).train()
    taps = [_nchw(t).clone().requires_grad_() for t in rig["taps"]]
    heat, feat = m(taps)
    loss = (heat.permute(0, 2, 3, 1) * torch.from_numpy(rig["ch"])).sum() \
        + (feat.permute(0, 2, 3, 1) * torch.from_numpy(rig["cf"])).sum()
    loss.backward()
    got = jax.tree_util.tree_leaves_with_path(_heads_grad_tree(m))
    want = rig["grad_params"]
    assert len(got) == len(jax.tree_util.tree_leaves(want))
    for path, g in got:
        w = want
        for k in path:
            w = w[k.key]
        _close(g, w, atol=ATOL * max(1.0, float(np.abs(w).max())),
               msg=jax.tree_util.keystr(path))
    for t, w in zip(taps, rig["grad_taps"]):
        _close(_nhwc(t.grad), w, atol=ATOL * max(1.0, float(np.abs(w).max())))


def test_fuse_and_unfuse_match_jax(rig):
    """The port's unfuse of the fused state holds JAX's unfuse of the
    fused tree, bit for bit; fuse after unfuse gives the state back."""
    state = _wrapped(_heads(rig))
    per_head = unfuse_head_variables(state)
    hp, hs = jdet.unfuse_head_variables(rig["fp"], rig["fs"], conv_dim=D)
    want = {}
    for (key, name, _), dim in zip(HEADS + (("feature", "feature", 0),),
                                   list(HEAD_DIMS) + [FDIM]):
        for lv in range(4):
            for t, j in (("weight", "scale"), ("bias", "bias")):
                want[f"{key}.in_bn.{lv}.{t}"] = hp[name][f"in_bn{lv}"][j]
            for t, j in (("running_mean", "mean"), ("running_var", "var")):
                want[f"{key}.in_bn.{lv}.{t}"] = hs[name][f"in_bn{lv}"][j]
            want[f"{key}.upsamplers.{lv}.0.weight"] = np.transpose(
                hp[name][f"up{lv}_conv"]["kernel"], (3, 2, 0, 1))
            for t, j in (("weight", "scale"), ("bias", "bias")):
                want[f"{key}.upsamplers.{lv}.1.{t}"] = \
                    hp[name][f"up{lv}_bn"][j]
            for t, j in (("running_mean", "mean"), ("running_var", "var")):
                want[f"{key}.upsamplers.{lv}.1.{t}"] = \
                    hs[name][f"up{lv}_bn"][j]
        want[f"{key}.top_conv.0.weight"] = np.transpose(
            hp[name]["top_conv"]["kernel"], (3, 2, 0, 1))
        want[f"{key}.top_conv.0.bias"] = hp[name]["top_conv"]["bias"]
    counters = {k for k in per_head if k.endswith("num_batches_tracked")}
    assert set(per_head) - counters == set(want)
    assert all(int(per_head[k]) == 0 for k in counters)
    for k, v in want.items():
        np.testing.assert_array_equal(per_head[k].numpy(), v, err_msg=k)
    back = fuse_head_variables(per_head)
    assert set(back) == set(state)
    for k, v in state.items():
        assert torch.equal(back[k], v), k


def test_port_fused_matches_port_per_head(rig):
    """The port's fused heads against its own per-head Leafmaps on
    :func:`unfuse_head_variables` of the same weights: outputs in eval and
    train mode, every parameter gradient (unfused), and the updated
    running statistics."""
    fused = _heads(rig)
    per_head = PerHead()
    per_head.load_state_dict(unfuse_head_variables(_wrapped(fused)))
    taps = [_nchw(t) for t in rig["taps"]]
    with torch.no_grad():
        for mode in (False, True):
            got = fused.train(mode)(taps)
            want = per_head.train(mode)(taps)
            for g, w in zip(got, want):
                _close(g.numpy(), w.numpy())
    fused, per_head = _heads(rig).train(), PerHead().train()
    per_head.load_state_dict(unfuse_head_variables(_wrapped(fused)))
    for m in (fused, per_head):
        heat, feat = m(taps)
        (heat.square().sum() + (feat * feat.detach().sin()).sum()).backward()
    grads = {f"heads.{k}": p.grad for k, p in fused.named_parameters()}
    grads.update({f"heads.{k}": b for k, b in fused.named_buffers()
                  if k != "scalar_select"})
    grads = unfuse_head_variables(grads)
    for k, p in per_head.named_parameters():
        w = p.grad.numpy()
        _close(grads[k].numpy(), w,
               atol=ATOL * max(1.0, float(np.abs(w).max())), msg=k)
    stats = unfuse_head_variables(_wrapped(fused))
    for k, v in per_head.state_dict().items():
        if "running" in k:
            _close(stats[k].numpy(), v.numpy(), 0, STAT_ATOL, msg=k)


@pytest.fixture(scope="module")
def tiny():
    """Tiny JAX detector variables drawn with numpy, per-head and fused
    (JAX's ``fuse_head_variables`` of the same heads)."""
    x = jnp.zeros((1, 64, 64, 3))
    shapes = jax.eval_shape(jdet.CenterNetDetection("tiny", FDIM).init,
                            jax.random.PRNGKey(0), x)
    rng = np.random.default_rng(1)
    v = {"params": _draw(shapes["params"], rng),
         "batch_stats": _draw(shapes["batch_stats"], rng)}
    fp, fs = jdet.fuse_head_variables(
        {h: v["params"][h] for h in NAMES},
        {h: v["batch_stats"][h] for h in NAMES}, feature_dim=FDIM)
    vf = {"params": {"backbone": v["params"]["backbone"], "heads": fp},
          "batch_stats": {"backbone": v["batch_stats"]["backbone"],
                          "heads": fs}}
    return v, vf


@pytest.fixture
def no_drop_path(monkeypatch):
    monkeypatch.setattr(jeff, "STOCHASTIC_DEPTH_PROB", 0.0)
    monkeypatch.setattr(teff, "STOCHASTIC_DEPTH_PROB", 0.0)


def test_centernet_fused_matches_jax(tiny, no_drop_path):
    """``CenterNetDetection("tiny", fused=True)`` on ``from_jax`` of JAX's
    fused tree: the eval outputs; then, both sides with ``remat=True`` in
    train mode (drop path off on both sides), the outputs, the heads'
    gradients and their updated running statistics."""
    _, vf = tiny
    x = np.random.default_rng(2).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    c = np.random.default_rng(3).standard_normal((2, 16, 16, 9)).astype(
        np.float32)
    jm = jdet.CenterNetDetection("tiny", FDIM, fused=True, remat=True)

    def loss(params, x):
        (heat, feat), upd = jm.apply(
            {"params": params, "batch_stats": vf["batch_stats"]}, x, True,
            mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)})
        return jnp.sum(heat * c) + jnp.sum(feat * feat), (heat, feat, upd)

    @jax.jit
    def reference(params, x):
        return (jm.apply({"params": params,
                          "batch_stats": vf["batch_stats"]}, x),
                jax.grad(loss, has_aux=True)(params, x))

    (eh, ef), (grads, (jh, jf, upd)) = reference(vf["params"],
                                                 jnp.asarray(x))
    # remat acts in train mode only: one module serves both checks
    m = CenterNetDetection("tiny", FDIM, fused=True, remat=True)
    m.load_state_dict(detector_state_from_flax(vf, "tiny"))
    with torch.no_grad():
        h, f = m.eval()(torch.from_numpy(x))
    _close(h.numpy(), eh)
    _close(f.numpy(), ef)
    h, f = m.train()(torch.from_numpy(x))
    ((h * torch.from_numpy(c)).sum() + (f * f).sum()).backward()
    _close(h.detach().numpy(), jh)
    _close(f.detach().numpy(), jf)
    jg = jax.tree_util.tree_map(np.asarray, grads["heads"])
    for path, g in jax.tree_util.tree_leaves_with_path(
            _heads_grad_tree(m.heads)):
        w = jg
        for k in path:
            w = w[k.key]
        _close(g, w, atol=ATOL * max(1.0, float(np.abs(w).max())),
               msg=jax.tree_util.keystr(path))
    want = detector_state_from_flax(
        {"params": vf["params"],
         "batch_stats": jax.tree_util.tree_map(np.asarray,
                                               upd["batch_stats"])}, "tiny")
    got = m.state_dict()
    for k, v in want.items():
        if k.startswith("heads.") and k.endswith(("mean", "var")):
            _close(got[k].numpy(), v.numpy(), 0, STAT_ATOL, msg=k)


def test_from_jax_of_the_fused_tree_is_the_ports_fuse(tiny):
    v, vf = tiny
    want = fuse_head_variables(detector_state_from_flax(v, "tiny"))
    got = detector_state_from_flax(vf, "tiny")
    assert set(got) == set(want)
    for k, t in want.items():
        assert torch.equal(got[k], t), k
    assert set(got) == set(CenterNetDetection(
        "tiny", FDIM, fused=True).state_dict())


def test_model_pt_out_of_and_into_a_fused_model_match_jax(tiny, tmp_path):
    """Reference ``model.pt`` from a fused port state equals JAX's
    ``export_detector_sd`` of the fused tree (keys and values); loading it
    back fused equals JAX's ``import_detector(fused=True)`` and the state
    it came from; a stray head key still raises."""
    _, vf = tiny
    state = detector_state_from_flax(vf, "tiny")
    want = jexport_detector_sd(
        {"params": {"detector": vf["params"]},
         "batch_stats": {"detector": vf["batch_stats"]}}, "tiny")
    got = export_detector_sd(state)
    assert set(got) == set(want)
    for k, a in want.items():
        np.testing.assert_array_equal(got[k].numpy(), a, err_msg=k)
    path = save_torch_checkpoint(str(tmp_path / "model.pt"), got)
    loaded = load_torch_state_dict(path)
    det, dec = split_detector_state(loaded, fused=True)
    assert not dec and set(det) == set(state)
    jv = import_detector({k: v.numpy() for k, v in loaded.items()}, "tiny",
                         fused=True)
    jstate = detector_state_from_flax(
        {"params": jv["params"]["detector"],
         "batch_stats": jv["batch_stats"]["detector"]}, "tiny")
    for k, t in state.items():
        assert torch.equal(det[k], t), k
        assert torch.equal(det[k], jstate[k]), k
    with pytest.raises(ValueError, match="fused schedule"):
        split_detector_state({**loaded, "detector.sizes.extra":
                              torch.zeros(1)}, fused=True)


def _jax_layout(t, path):
    """A port tensor in JAX's layout: a backbone kernel (or its scale)
    OIHW -> HWIO; the fused heads' tensors are in JAX's layout already."""
    a = t.float().numpy() if t.is_floating_point() else t.numpy()
    if path.startswith("heads/") or a.ndim != 4:
        return a
    return np.transpose(a, (2, 3, 1, 0))


def test_quantize_of_a_fused_state_matches_jax(tiny):
    _, vf = tiny
    state = detector_state_from_flax(vf, "tiny")
    paths = flax_paths(state)
    jq_tree, jscales = jq.quantize_params(vf["params"])
    q, scales = tq.quantize_params(state)
    assert {paths[k] for k in scales} == set(jscales)
    for i in range(4):
        assert scales[f"heads.up{i}_tap_kernel"].shape == (1, 1, 1, 1, 192)
    assert not any(k.startswith("heads.top_") for k in scales)
    for k, s in scales.items():
        p = paths[k]
        leaf = jq_tree
        for part in p.split("/"):
            leaf = leaf[part]
        np.testing.assert_array_equal(_jax_layout(q[k], p), leaf, err_msg=k)
        np.testing.assert_array_equal(_jax_layout(s, p), jscales[p],
                                      err_msg=k)


def _rank_main(rank, world, path):
    """One rank of the gloo run: its rows of the batch through the fused
    heads in train mode, statistics over the world, and a backward."""
    torch.set_num_threads(1)
    from findtextcenternet_tpu_torch.parallel.distributed import (
        init_distributed)
    init_distributed(f"file://{path}/init", world, rank, device="cpu")
    try:
        data = torch.load(os.path.join(path, "in.pt"))
        m = FusedLeafmaps(TAP_CH, HEAD_DIMS, FDIM, D).train()
        m.load_state_dict(data["state"])
        set_sync_group(m, torch.distributed.group.WORLD)
        n = data["taps"][0].shape[0] // world
        rows = slice(rank * n, (rank + 1) * n)
        out = _train_step(m, [t[rows] for t in data["taps"]],
                          data["ch"][rows], data["cf"][rows])
        torch.save(out, os.path.join(path, f"out{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def _train_step(m, taps, ch, cf):
    taps = [t.clone().requires_grad_() for t in taps]
    heat, feat = m(taps)
    ((heat * ch).sum() + (feat * cf).sum()).backward()
    return {"heat": heat.detach(), "feat": feat.detach(),
            "taps": [t.grad for t in taps],
            "grads": {k: p.grad for k, p in m.named_parameters()},
            "state": m.state_dict()}


def test_two_gloo_ranks_equal_one_process(rig, tmp_path):
    """The fused heads under ``set_sync_group`` on 2 gloo ranks, 2 rows
    each, against one process on all 4 rows: outputs, tap gradients,
    parameter gradients summed over the ranks (the global loss is the sum
    of the ranks'), and every rank's running statistics."""
    rng = np.random.default_rng(4)
    taps = [torch.from_numpy((0.7 + 1.5 * rng.standard_normal(
        (4, c, 16 >> i, 16 >> i))).astype(np.float32))
        for i, c in enumerate(TAP_CH)]
    ch = torch.from_numpy(rng.standard_normal(
        (4, sum(HEAD_DIMS), 16, 16)).astype(np.float32))
    cf = torch.from_numpy(rng.standard_normal((4, FDIM, 16, 16)).astype(
        np.float32))
    state = _heads(rig).state_dict()
    torch.save({"state": state, "taps": taps, "ch": ch, "cf": cf},
               tmp_path / "in.pt")
    mp.spawn(_rank_main, args=(2, str(tmp_path)), nprocs=2, join=True)
    ranks = [torch.load(tmp_path / f"out{r}.pt") for r in range(2)]
    m = FusedLeafmaps(TAP_CH, HEAD_DIMS, FDIM, D).train()
    m.load_state_dict(state)
    want = _train_step(m, taps, ch, cf)
    for k in ("heat", "feat"):
        _close(torch.cat([r[k] for r in ranks]).numpy(), want[k].numpy(),
               msg=k)
    for i, w in enumerate(want["taps"]):
        _close(torch.cat([r["taps"][i] for r in ranks]).numpy(), w.numpy(),
               atol=ATOL * max(1.0, float(w.abs().max())))
    for k, w in want["grads"].items():
        _close(sum(r["grads"][k] for r in ranks).numpy(), w.numpy(),
               atol=ATOL * max(1.0, float(w.abs().max())), msg=k)
    for r in ranks:
        for k, w in want["state"].items():
            if k.endswith(("mean", "var")):
                _close(r["state"][k].numpy(), w.numpy(), 0, STAT_ATOL,
                       msg=k)
