"""The port's mesh layer (``findtextcenternet_tpu_torch/parallel``) against
the JAX package's, in one process on the CPU.

The sharding rules are data copied from JAX, so they are held leaf by leaf:
the TP spec of every parameter and the ZeRO-1 spec of every optimizer
leaf of the tiny Transformer's and detector's train states equal JAX's
``state_shardings`` (its spec moved to the torch layout: Dense kernels
transposed, convolutions HWIO -> OIHW) on (2,1), (2,2), (4,1) and (1,2)
meshes; JAX's state is abstract (``jax.eval_shape``), the port's a layout
:class:`Mesh` with no process group. The rows ``shard_batch`` gives each
rank equal JAX's ``P(None, 'data')`` micro-batch shards. The collectives
are the identity without a process group. Multi-rank runs are in
``test_torch_mesh_train.py`` and ``test_torch_mesh_pipeline.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from findtextcenternet_tpu_torch.config import Config
from findtextcenternet_tpu_torch.io.from_jax import flax_paths
from findtextcenternet_tpu_torch.parallel import (
    Mesh, make_mesh, param_pspec, shard_batch, state_shardings,
    tree_pspecs)
from findtextcenternet_tpu_torch.parallel import collectives as coll
from findtextcenternet_tpu_torch.parallel import distributed
from findtextcenternet_tpu_torch.parallel.mesh import (
    batch_rows, jax_perm, leaf_sharding, to_torch_spec)
from findtextcenternet_tpu_torch.train import train1, train3

MESHES = [(2, 1), (2, 2), (4, 1), (1, 2)]


def _tiny_config():
    c = Config()
    return dataclasses.replace(
        c, detector=dataclasses.replace(
            c.detector, model_size="tiny", feature_dim=8, decoder_mid_dim=32,
            image_size=(64, 64), fmask_topk_per_sample=8),
        transformer=dataclasses.replace(
            c.transformer, enc_input_dim=20, embed_dim=32, head_num=4,
            enc_block_num=1, dec_block_num=1, max_enc_seq_len=16,
            max_dec_seq_len=16, attn_impl="xla"))


def _key_str(k):
    from jax.tree_util import (DictKey, FlattenedIndexKey, GetAttrKey,
                               SequenceKey)
    if isinstance(k, DictKey):
        return str(k.key)
    if isinstance(k, GetAttrKey):
        return k.name
    if isinstance(k, (SequenceKey, FlattenedIndexKey)):
        return str(getattr(k, "idx", getattr(k, "key", "")))
    return str(k)


def _jax_specs(kind, n_data, n_model):
    """{(buffer or "params", flax param path): spec on the JAX layout} of
    JAX's ``state_shardings(zero1=True)`` for the tiny state, and the
    leaves' shapes."""
    import jax
    import jax.numpy as jnp

    from findtextcenternet_tpu.parallel import make_mesh as jmake_mesh
    from findtextcenternet_tpu.parallel import state_shardings as jstate_sh
    from findtextcenternet_tpu.train.state import (
        create_train_state, make_schedule_free_adamw,
        make_schedule_free_radam)

    if kind == "transformer":
        from findtextcenternet_tpu.models import transformer as jt
        model = jt.Transformer(jt.TransformerDims(
            enc_input_dim=20, embed_dim=32, head_num=4, enc_block_num=1,
            dec_block_num=1, max_enc_seq_len=16, max_dec_seq_len=16))
        args = (jnp.zeros((1, 16, 20)), jnp.zeros((1, 16), jnp.int32))
        tx, ncov = make_schedule_free_radam(1e-3), 0
    else:
        from findtextcenternet_tpu.models.detector import TextDetectorModel
        model = TextDetectorModel("tiny", feature_dim=8, decoder_mid_dim=32)
        args = (jnp.zeros((1, 64, 64, 3)), jnp.zeros((8,), jnp.int32))
        tx, ncov = make_schedule_free_adamw(1e-3, 2), 9
    state = jax.eval_shape(lambda: create_train_state(
        model.apply, model.init(jax.random.PRNGKey(0), *args), tx, ncov))
    sh = jstate_sh(state, jmake_mesh(n_data, n_model), zero1=True)
    specs, shapes = {}, {}
    flat_sh = jax.tree_util.tree_flatten_with_path(sh)[0]
    flat_st = jax.tree_util.tree_flatten_with_path(state)[0]
    for (path, s), (_, leaf) in zip(flat_sh, flat_st):
        parts = [_key_str(k) for k in path]
        if parts[0] == "params":
            key = ("params", "/".join(parts[1:]))
        elif parts[0] == "opt_state":
            buf = next((p for p in parts if p in ("z", "mu", "nu")), None)
            if buf is None:
                continue                 # scalars: counts, weight sums
            key = (buf, "/".join(parts[parts.index(buf) + 1:]))
        else:
            continue
        spec = tuple(s.spec) + (None,) * (leaf.ndim - len(tuple(s.spec)))
        specs[key], shapes[key] = spec, leaf.shape
    return specs, shapes


@pytest.fixture(scope="module")
def port_states():
    cfg = _tiny_config()
    with torch.random.fork_rng():
        _, tf = train3.build_transformer_state(cfg, seed=0, device="cpu")
        _, det = train1.build_detector_state(cfg, seed=0, device="cpu")
    return {"transformer": tf, "detector": det}


@pytest.mark.parametrize("kind", ["transformer", "detector"])
@pytest.mark.parametrize("n_data,n_model", MESHES)
def test_state_shardings_match_jax(port_states, kind, n_data, n_model):
    """Every parameter's TP spec and every ``z``/``mu``/``nu`` leaf's
    ZeRO-1 spec equal JAX's, leaf by leaf, on the torch layout."""
    state = port_states[kind]
    want, shapes = _jax_specs(kind, n_data, n_model)
    got = state_shardings(state, Mesh(n_data, n_model), zero1=True)
    paths = flax_paths(state.model.state_dict().keys())
    seen = 0
    for name, p in state.optimizer.params.items():
        path = paths[name]
        perm = jax_perm(path, p.dim())
        key = ("params", path)
        assert tuple(p.shape[i] for i in perm) == tuple(shapes[key]), name
        assert got["params"][name] == to_torch_spec(want[key], perm), name
        for buf in state.optimizer.BUFFERS:
            jkey = (buf, path)
            assert got["opt_state"][buf][name] == \
                to_torch_spec(want[jkey], perm), (buf, name)
            seen += 1
    assert seen == len(state.optimizer.params) * len(state.optimizer.BUFFERS)
    # ZeRO-1 split something, and only where the TP rules did not
    zero = [n for n, s in got["opt_state"]["z"].items() if "data" in s]
    assert (len(zero) > 0) == (n_data > 1)
    assert not any("model" in got["opt_state"]["z"][n] for n in zero)


def test_tp_rules_are_jax_data():
    from findtextcenternet_tpu.parallel import mesh as jmesh
    for path in ("encoder/block0/mha/q_proj/kernel",
                 "decoder/block1/cross_attn/out_proj/kernel",
                 "encoder/block0/ff/w1/kernel", "encoder/block0/ff/wg/bias",
                 "encoder/block0/ff/w2/kernel", "encoder/block0/ff/w2/bias",
                 "decoder/block2_fc0/kernel", "decoder/block0_fc1/kernel",
                 "decoder/block0_bn0/scale", "encoder/norm/scale"):
        assert param_pspec(path) == tuple(jmesh.param_pspec(path)), path
    tree = {"a": {"ff": {"w1": {"kernel": 0, "bias": 0}}}, "b": 0}
    assert tree_pspecs(tree) == {"a": {"ff": {"w1": {
        "kernel": (None, "model"), "bias": ("model",)}}}, "b": ()}
    leaf = np.zeros((6, 5))
    assert leaf_sharding(Mesh(1, 2), (None, "model"), leaf) == ()
    assert leaf_sharding(Mesh(1, 5), (None, "model"), leaf) == \
        (None, "model")


@pytest.mark.parametrize("n_data,accum", [(2, 1), (2, 2), (4, 2)])
def test_batch_rows_are_jax_micro_shards(n_data, accum):
    """Rank r's rows, micro-batch by micro-batch, are the rows JAX's
    ``(accum, B/accum)`` reshape places on data index r under
    ``P(None, 'data')``."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from findtextcenternet_tpu.parallel import make_mesh as jmake_mesh

    b = 8
    mesh = jmake_mesh(n_data, 1)
    x = np.arange(b).reshape(accum, b // accum)
    arr = jax.device_put(x, NamedSharding(mesh, P(None, "data")))
    by_dev = {s.device: np.asarray(s.data).reshape(-1)
              for s in arr.addressable_shards}
    for r in range(n_data):
        want = by_dev[mesh.devices[r, 0]]
        got = batch_rows(b, Mesh(n_data, 1, data_rank=r), accum)
        np.testing.assert_array_equal(got, want)
        batch = {"x": np.arange(b) * 10, "t": torch.arange(b)}
        part = shard_batch(batch, Mesh(n_data, 1, data_rank=r), accum)
        np.testing.assert_array_equal(part["x"], want * 10)
        assert part["t"].tolist() == want.tolist()
    with pytest.raises(ValueError, match="micro-batches"):
        batch_rows(6, Mesh(4, 1), 1)


def test_one_process_mesh_and_identity_collectives(monkeypatch):
    for k in ("JAX_COORDINATOR", "JAX_NUM_PROCESSES", "MASTER_ADDR",
              "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.init_distributed(device="cpu") is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    assert distributed.init_distributed(device="cpu") is False
    assert not coll.initialized()
    mesh = make_mesh()
    assert (mesh.n_data, mesh.n_model, mesh.data_group) == (1, 1, None)
    with pytest.raises(ValueError):
        make_mesh(n_data=2)
    assert list(distributed.host_shard_range(10)) == list(range(10))
    t = torch.arange(6.0).reshape(2, 3)
    assert coll.all_reduce_(t, mesh.data_group) is t
    assert coll.all_gather(t, mesh.data_group, 1) is t
    assert coll.reduce_scatter(t, mesh.data_group, 0) is t
    assert coll.copy_to_group(t, None) is t
    assert coll.gather_from_group(t, None) is t
    assert coll.broadcast_batch({"x": 1}, "cpu") == {"x": 1}
    out = distributed.global_batch_from_host({"x": np.ones((2, 3))}, mesh,
                                             device="cpu")
    assert out["x"].shape == (2, 3) and out["x"].device.type == "cpu"


@pytest.fixture
def world_of_one(tmp_path):
    """A gloo process group of one rank in this process and its mesh."""
    assert distributed.init_distributed(f"file://{tmp_path}/init", 1, 0,
                                        device="cpu", always=True)
    try:
        yield make_mesh()
    finally:
        torch.distributed.destroy_process_group()


def test_world_of_one_runs_every_collective(world_of_one):
    """A world of 1 with a process group has active groups: every
    collective runs (gloo here, NCCL on the card) and gives back its
    input, forward and backward."""
    mesh = world_of_one
    g, m = mesh.data_group, mesh.model_group
    assert coll.active(g) and coll.active(m) and coll.size(g) == 1
    x = torch.arange(24.0).reshape(2, 3, 4)
    for y in (coll.all_reduce_(x.clone(), g), coll.all_gather(x, g, 1),
              coll.reduce_scatter(x, g, 2), coll.broadcast_(x.clone(), 0, m),
              coll.broadcast_batch({"x": x.numpy()}, "cpu")["x"]):
        assert y is not x and torch.equal(y, x)
    # a strided tensor goes out contiguous
    y = coll.broadcast_batch({"x": x[:, 1]}, "cpu")["x"]
    assert y.is_contiguous() and torch.equal(y, x[:, 1])
    xg = x.clone().requires_grad_()
    y = coll.reduce_from_group(coll.copy_to_group(xg, m), m)
    y = coll.all_reduce_sum(coll.gather_from_group(y, m, -1), g)
    w = torch.randn(x.shape)
    (gx,) = torch.autograd.grad((y * w).sum(), xg)
    assert torch.equal(y, x) and torch.equal(gx, w)


def test_world_of_one_steps_equal_plain(world_of_one):
    """Through the world-1 mesh's collectives a ZeRO-1 Transformer step is
    bit-equal to the plain step; the detector step (its BatchNorms on the
    sync path, f32) equals the plain one at 1e-5 and its update within
    1e-3 of the update's norm."""
    from findtextcenternet_tpu_torch.train.state import RAdam
    from findtextcenternet_tpu_torch.train.state import (
        trainable_parameters)
    from findtextcenternet_tpu_torch.train.steps import (
        detector_train_step, transformer_train_step)

    cfg = _tiny_config()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, zero1=True))
    rng = np.random.default_rng(0)
    true = rng.integers(4, 70000, (4, 16)).astype(np.int32)
    tbatch = {"encoder_input": rng.standard_normal((4, 16, 20)).astype(
        np.float32), "decoder_input": np.where(
        rng.uniform(size=true.shape) < 0.5, 3, true), "decoder_true": true}
    dbatch = {"image": rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32),
              "labelmap": rng.uniform(0, 1, (2, 16, 16, 5)).astype(
                  np.float32),
              "idmap": rng.integers(0, 0x3000, (2, 16, 16, 2)).astype(
                  np.int32)}
    out = {}
    for name, mesh in (("plain", None), ("mesh", world_of_one)):
        _, ts = train3.build_transformer_state(cfg, mesh, 0, device="cpu")
        _, tm = transformer_train_step(ts, tbatch)
        model, ds = train1.build_detector_state(cfg, mesh, 0, device="cpu")
        ds.compute_dtype = torch.float32
        ds.optimizer = RAdam(trainable_parameters(model), 1e-3, 1, 1.0)
        if mesh is not None:
            from findtextcenternet_tpu_torch.train.state import use_mesh
            use_mesh(ds, mesh, zero1=True)
        before = {n: p.detach().clone()
                  for n, p in ds.optimizer.params.items()}
        _, dm = detector_train_step(ds, dbatch, fmask_k=8)
        out[name] = (float(tm["loss"]), dict(ts.optimizer.params),
                     {k: float(v) for k, v in dm.items()},
                     torch.cat([(p.detach() - before[n]).reshape(-1)
                                for n, p in ds.optimizer.params.items()]))
    assert out["mesh"][0] == out["plain"][0]
    for n, p in out["plain"][1].items():
        assert torch.equal(out["mesh"][1][n], p), n
    for k, w in out["plain"][2].items():
        np.testing.assert_allclose(out["mesh"][2][k], w, rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    upd = out["plain"][3]
    assert float(upd.norm()) > 0.0
    assert float((out["mesh"][3] - upd).norm()) <= 1e-3 * float(upd.norm())


@pytest.mark.parametrize("shape", [(3, 5, 4, 4), (7, 6)])
def test_sync_batchnorm_matches_batch_norm(tmp_path, shape):
    """The sync BatchNorm's forward and hand-written backward equal
    ``F.batch_norm`` in training mode and its autograd gradients (f64),
    without a group and through a gloo world of 1."""
    from findtextcenternet_tpu_torch.models.batchnorm import _SyncBatchNorm

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(shape, generator=gen, dtype=torch.float64) * 3 + 1
    w, b = (torch.randn(shape[1], generator=gen, dtype=torch.float64)
            for _ in range(2))
    dy = torch.randn(shape, generator=gen, dtype=torch.float64)

    def grads(fn):
        args = [t.clone().requires_grad_() for t in (x, w, b)]
        y = fn(*args)
        return (y,) + torch.autograd.grad((y * dy).sum(), args)

    want = grads(lambda x_, w_, b_: torch.nn.functional.batch_norm(
        x_, None, None, w_, b_, True, 0.1, 1e-3))
    distributed.init_distributed(f"file://{tmp_path}/init", 1, 0,
                                 device="cpu", always=True)
    try:
        for group in (None, make_mesh().data_group):
            got = grads(lambda x_, w_, b_: _SyncBatchNorm.apply(
                x_, w_, b_, 1e-3, group)[0])
            for g, t, name in zip(got, want, ("y", "dx", "dw", "db")):
                torch.testing.assert_close(g, t, rtol=1e-10, atol=1e-10,
                                           msg=name)
    finally:
        torch.distributed.destroy_process_group()
