"""The port's mesh training (``torch.distributed`` over spawned gloo ranks
on the CPU) against the JAX package's GSPMD mesh steps on the conftest's
8 virtual CPU devices.

One rank world of 2 and one of 4 run every job below (module fixture);
the ranks import no JAX. Each job builds its state through the port's
entry points (``train3.build_transformer_state(config, mesh, shard_tp=)``,
``train1.build_detector_state(config, mesh)``) from seed 0; the JAX side
imports those initial weights with its own ``io.torch_import`` and steps on
``make_mesh(n_data, n_model)`` with the layout of its ``state_shardings``
(micro-batches under ``P(None, 'data')`` at ``accum_steps=2``).

* The Transformer (32 wide, 4 heads, 1+1 blocks, 16 tokens), two steps at
  2 ranks, at 2 ranks with ZeRO-1, at (1 data, 2 model) with the TP split,
  and at 4 ranks with ``accum_steps=2``: the loss and every parameter
  equal JAX's mesh step at rtol 2e-5, atol 2e-6, the tolerance of JAX's
  own ``test_zero1_opt_state_sharding_equivalence``.
* The tiny detector, two steps at 2 ranks, the first on a batch whose
  second rank's rows hold no keypoints, the second on one whose ranks
  hold different numbers of them (a rank's local BN statistics, top-k
  selection or loss counts would be far off), with plain RAdam (its early updates are
  proportional to the gradients, so the parameters check the gradients),
  drop path off on both sides (the packages' masks cannot agree), f32:
  the metrics rtol 1e-5, the parameters, BN buffers and CoV statistics
  atol/rtol 1e-4 (the tolerances of ``test_torch_detector_train.py``).
  The same steps at (2 data, 2 model) with ZeRO-1, the SimpleDecoder split
  over ``model`` (``block*_fc0`` by columns, ``block*_fc1`` by rows) and its
  first BatchNorm's gradients summed over ``model``, equal JAX's TP mesh
  steps, on (1 data, 2 model) with ``state_shardings(zero1=True)`` (the
  TP rules JAX's train1 applies), and one port process, at the same
  tolerances. JAX's own (2, 2) step is no reference: its (2, 1) and
  (1, 2) steps equal its one-device step, but on XLA:CPU's virtual
  devices its (2, 2) step's gradients of three depthwise convolution
  kernels (block 0 of stages 3-5) come out twice the one-device ones, a
  double count over ``model``.
* Dropout 0.1: 2 ranks equal one port process (masks drawn at the global
  batch and sliced), rtol 2e-5, atol 2e-6.
* A ZeRO-1 checkpoint written by 2 ranks after step 1 resumes in one
  process, whose step 2 equals the ranks' step 2 (same tolerance).

The training CLIs on several ranks: ``test_torch_mesh_cli.py``.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from findtextcenternet_tpu_torch.config import Config
from findtextcenternet_tpu_torch.data.targets import make_target_maps
from findtextcenternet_tpu_torch.models import efficientnet as teff
from findtextcenternet_tpu_torch.train import checkpoint as ckpt
from findtextcenternet_tpu_torch.train import train1, train3
from findtextcenternet_tpu_torch.train.state import (
    RAdam, trainable_parameters, use_mesh)
from findtextcenternet_tpu_torch.train.steps import (
    detector_train_step, transformer_train_step)

LR, DET_LR = 2.5e-3, 0.05
STEPS = 2
TF_TOL = dict(rtol=2e-5, atol=2e-6)
DET_TOL = 1e-4
# job -> (n_data, n_model, accum_steps, dropout, zero1)
TF_JOBS = {"dp2": (2, 1, 1, 0.0, False), "dp2_zero1": (2, 1, 1, 0.0, True),
           "tp2": (1, 2, 1, 0.0, False), "dropout_dp2": (2, 1, 1, 0.1, False),
           "dp4_accum2": (4, 1, 2, 0.0, False)}
DET_JOBS = {"det_dp2": (2, 1, False), "det_tp_zero1": (2, 2, True)}
# job -> JAX's mesh and ZeRO-1 setting it is held against (module doc)
JAX_DET = {"det_dp2": (2, 1, False), "det_tp_zero1": (1, 2, True)}
WORLDS = {2: ["dp2", "dp2_zero1", "tp2", "dropout_dp2", "det_dp2"],
          4: ["dp4_accum2", "det_tp_zero1"]}
JAX_TF = ("dp2", "dp2_zero1", "tp2", "dp4_accum2")


def _tf_config(dropout=0.0, zero1=False, accum=1):
    c = Config()
    return dataclasses.replace(
        c, transformer=dataclasses.replace(
            c.transformer, enc_input_dim=20, embed_dim=32, head_num=4,
            enc_block_num=1, dec_block_num=1, max_enc_seq_len=16,
            max_dec_seq_len=16, dropout=dropout, attn_impl="xla"),
        train=dataclasses.replace(c.train, learning_rate=LR, zero1=zero1,
                                  accum_steps=accum))


def _tf_batch(seed, b=8):
    rng = np.random.default_rng(seed)
    enc = rng.standard_normal((b, 16, 20)).astype(np.float32)
    enc[1, 9:] = 0.0                   # padded tail rows (masked keys)
    true = rng.integers(4, 70000, (b, 16)).astype(np.int32)
    true[2, 11:] = 0                   # PAD targets carry no loss
    inp = np.where(rng.uniform(size=(b, 16)) < 0.5, 3, true).astype(np.int32)
    return {"encoder_input": enc, "decoder_input": inp, "decoder_true": true}


def _det_config(zero1=False):
    c = Config()
    return dataclasses.replace(
        c, detector=dataclasses.replace(
            c.detector, model_size="tiny", feature_dim=8, decoder_mid_dim=32,
            image_size=(64, 64), fmask_topk_per_sample=8),
        train=dataclasses.replace(c.train, zero1=zero1))


def _det_batch(seed, n=4):
    """Images and painted targets. At seed 0 rows 2 and 3 (the second
    rank's at 2 data ranks) hold no keypoints; at other seeds every row
    holds 1-9, so the ranks' counts differ."""
    rng = np.random.default_rng(seed)
    mh = 16
    labels, ids = [], []
    for i in range(n):
        k = 0 if seed == 0 and i >= n // 2 else int(rng.integers(1, 10))
        pos = np.stack([rng.uniform(8, 56, k), rng.uniform(8, 56, k),
                        rng.uniform(6, 20, k), rng.uniform(6, 20, k)],
                       1).reshape(k, 4)
        codes = np.stack([rng.integers(0x20, 0x3000, k),
                          rng.integers(0, 16, k)], 1).reshape(k, 2)
        keysize, idmap, _ = make_target_maps(pos.astype(np.float32),
                                             codes.astype(np.int32),
                                             (mh, mh))
        lines = (rng.uniform(size=(mh, mh, 2)) > 0.7).astype(np.float32)
        labels.append(np.concatenate([keysize, lines], -1))
        ids.append(idmap)
    return {"image": rng.uniform(0, 1, (n, 64, 64, 3)).astype(np.float32),
            "labelmap": np.stack(labels).astype(np.float32),
            "idmap": np.stack(ids).astype(np.int32)}


def _whole(model):
    from findtextcenternet_tpu_torch.parallel.mesh import gather_tp
    return {k: v.detach().clone() for k, v in gather_tp(
        {k: v.detach() for k, v in model.state_dict().items()},
        model).items()}


def _tf_run(mesh, job, ckpt_dir=None):
    """Two steps of a Transformer job; (losses, final whole params)."""
    from findtextcenternet_tpu_torch.parallel import shard_batch
    n_data, n_model, accum, dropout, zero1 = TF_JOBS[job]
    cfg = _tf_config(dropout, zero1, accum)
    model, state = train3.build_transformer_state(
        cfg, mesh, 0, shard_tp=mesh is not None and n_model > 1,
        device="cpu")
    losses = []
    for i in range(STEPS):
        b = _tf_batch(i)
        if mesh is not None:
            b = shard_batch(b, mesh, accum)
        state, m = transformer_train_step(state, b, accum_steps=accum)
        losses.append(float(m["loss"]))
        if i == 0 and ckpt_dir:
            ckpt.save_checkpoint(ckpt_dir, state, cfg)
    return losses, _whole(model)


def _det_state(mesh, zero1):
    model, state = train1.build_detector_state(_det_config(zero1), mesh, 0,
                                               device="cpu")
    state.compute_dtype = torch.float32
    state.optimizer = RAdam(trainable_parameters(model), DET_LR, 1, 1.0)
    if mesh is not None:
        use_mesh(state, mesh, zero1=zero1)
    return model, state


def _det_run(mesh, job):
    from findtextcenternet_tpu_torch.parallel import shard_batch
    _, _, zero1 = DET_JOBS[job]
    model, state = _det_state(mesh, zero1)
    metrics = []
    for i in range(STEPS):
        b = _det_batch(i)
        if mesh is not None:
            b = shard_batch(b, mesh)
        state, m = detector_train_step(state, b, fmask_k=8)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, _whole(model), {k: v.clone() for k, v in
                                    state.cov.state_dict().items()}


def _rank_main(rank, world, path):
    """One rank: every job of its world, rank 0 saving the results."""
    torch.set_num_threads(1)
    teff.STOCHASTIC_DEPTH_PROB = 0.0
    from findtextcenternet_tpu_torch.parallel import make_mesh
    from findtextcenternet_tpu_torch.parallel.distributed import (
        init_distributed)
    init_distributed(f"file://{path}/init{world}", world, rank, device="cpu")
    try:
        for job in WORLDS[world]:
            if job in TF_JOBS:
                nd, nm = TF_JOBS[job][:2]
                out = _tf_run(make_mesh(nd, nm), job,
                              os.path.join(path, "ck") if job == "dp2_zero1"
                              else None)
            else:
                nd, nm = DET_JOBS[job][:2]
                out = _det_run(make_mesh(nd, nm), job)
            if rank == 0:
                torch.save(out, os.path.join(path, f"{job}.pt"))
    finally:
        torch.distributed.destroy_process_group()


@pytest.fixture(scope="module", autouse=True)
def one_thread_no_drop_path():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(teff, "STOCHASTIC_DEPTH_PROB", 0.0)
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{job: rank 0's result} from the worlds of 2 and 4 ranks, and the
    directory (with the ZeRO-1 checkpoint)."""
    path = str(tmp_path_factory.mktemp("mesh_train"))
    for world in WORLDS:
        mp.spawn(_rank_main, args=(world, path), nprocs=world, join=True)
    return {job: torch.load(os.path.join(path, f"{job}.pt"))
            for jobs in WORLDS.values() for job in jobs}, path


def _np(tree):
    import jax
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_tf():
    """{job: (losses, params as port state dict)} of JAX's mesh steps from
    the port's seed-0 weights."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from findtextcenternet_tpu.io.torch_import import import_transformer
    from findtextcenternet_tpu.models import transformer as jt
    from findtextcenternet_tpu.parallel import (
        make_mesh, shard_batch, state_shardings)
    from findtextcenternet_tpu.train.state import (
        create_train_state, make_schedule_free_radam)
    from findtextcenternet_tpu.train.steps import transformer_train_step
    from findtextcenternet_tpu_torch.io.from_jax import (
        transformer_state_from_flax)

    model, _ = train3.build_transformer_state(_tf_config(), device="cpu")
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    jdims = jt.TransformerDims(enc_input_dim=20, embed_dim=32, head_num=4,
                               enc_block_num=1, dec_block_num=1,
                               max_enc_seq_len=16, max_dec_seq_len=16)
    variables = import_transformer(sd, jdims)
    out = {}
    for job in JAX_TF:
        n_data, n_model, accum, _, zero1 = TF_JOBS[job]
        mesh = make_mesh(n_data, n_model)
        state = create_train_state(jt.Transformer(jdims).apply, variables,
                                   make_schedule_free_radam(LR))
        state = jax.tree_util.tree_map(
            jax.device_put, state, state_shardings(state, mesh, zero1=zero1))
        micro = NamedSharding(mesh, P(None, "data")) if accum > 1 else None
        step = jax.jit(lambda s, b, a=accum, m=micro: transformer_train_step(
            s, b, accum_steps=a, micro_sharding=m))
        losses = []
        for i in range(STEPS):
            state, m = step(state, shard_batch(_tf_batch(i), mesh))
            losses.append(float(m["loss"]))
        out[job] = (losses, transformer_state_from_flax(
            {"params": _np(state.params)}, model.dims, key_tables=False))
    return out


def _assert_close(got, want, err_msg="", **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               err_msg=err_msg, **tol)


@pytest.mark.parametrize("job", JAX_TF)
def test_transformer_mesh_step_matches_jax(ranks, jax_tf, job):
    losses, params = ranks[0][job]
    want_losses, want = jax_tf[job]
    _assert_close(losses, want_losses, "loss", **TF_TOL)
    for k, w in want.items():
        _assert_close(params[k].numpy(), w.numpy(), k, **TF_TOL)


@pytest.fixture(scope="module")
def jax_det():
    """{job: JAX's mesh detector steps} from the port's seed-0 weights on
    the job's ``JAX_DET`` mesh and ZeRO-1 setting: the metrics, the state
    as a port state dict, the CoV statistics."""
    import jax
    import optax

    from findtextcenternet_tpu.io.torch_import import import_detector
    from findtextcenternet_tpu.models import efficientnet as jeff
    from findtextcenternet_tpu.models.detector import TextDetectorModel
    from findtextcenternet_tpu.parallel import (
        make_mesh, shard_batch, state_shardings)
    from findtextcenternet_tpu.train.state import create_train_state
    from findtextcenternet_tpu.train.steps import detector_train_step
    from findtextcenternet_tpu_torch.io.from_jax import (
        cov_state_from_jax, text_detector_state_from_flax)

    model, _ = _det_state(None, False)
    variables = import_detector(
        {k: v.detach().numpy() for k, v in model.state_dict().items()},
        "tiny")
    jmodel = TextDetectorModel("tiny", feature_dim=8, decoder_mid_dim=32)
    out = {}
    for job, (n_data, n_model, zero1) in JAX_DET.items():
        mesh = make_mesh(n_data, n_model)
        state = create_train_state(jmodel.apply, variables,
                                   optax.radam(DET_LR), num_cov_losses=9)
        sh = state_shardings(state, mesh, zero1=zero1)
        if n_model > 1:
            # the TP rules split the SimpleDecoder's blocks
            assert any("model" in leaf.spec for leaf in
                       jax.tree_util.tree_leaves(sh.params))
        state = jax.tree_util.tree_map(jax.device_put, state, sh)
        with pytest.MonkeyPatch.context() as m:
            m.setattr(jeff, "STOCHASTIC_DEPTH_PROB", 0.0)
            step = jax.jit(lambda s, b: detector_train_step(s, b, fmask_k=8))
            metrics = []
            for i in range(STEPS):
                state, mt = step(state, shard_batch(_det_batch(i), mesh))
                metrics.append({k: float(v) for k, v in mt.items()})
        sd = text_detector_state_from_flax(
            {"params": _np(state.params),
             "batch_stats": _np(state.batch_stats)}, "tiny")
        out[job] = metrics, sd, cov_state_from_jax(_np(state.cov))
    return out


@pytest.mark.parametrize("job", list(DET_JOBS))
def test_detector_mesh_step_matches_jax(ranks, jax_det, job):
    """Global BN statistics, loss normalisers and top-k selection (the
    second data rank's rows hold no keypoints at step 1); at (2, 2) also
    the SimpleDecoder's TP split, against JAX's TP split, and ZeRO-1."""
    metrics, params, cov = ranks[0][job]
    want_metrics, want, want_cov = jax_det[job]
    assert want_metrics[0]["total"] > 0
    for got_m, want_m in zip(metrics, want_metrics):
        assert set(got_m) == set(want_m)
        for k, w in want_m.items():
            _assert_close(got_m[k], w, k, rtol=1e-5, atol=1e-6)
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        _assert_close(params[k].numpy(), w.numpy(), k, rtol=DET_TOL,
                      atol=DET_TOL)
    assert int(cov["t"]) == int(want_cov.t)
    for f in ("mean_L", "mean_l", "S_l"):
        _assert_close(cov[f].numpy(), getattr(want_cov, f).numpy(), f,
                      rtol=DET_TOL, atol=DET_TOL)


def test_detector_tp_zero1_matches_one_process(ranks):
    metrics, params, cov = ranks[0]["det_tp_zero1"]
    want_metrics, want, want_cov = _det_run(None, "det_tp_zero1")
    for got_m, want_m in zip(metrics, want_metrics):
        for k, w in want_m.items():
            _assert_close(got_m[k], w, k, rtol=1e-5, atol=1e-6)
    for k, w in want.items():
        _assert_close(params[k].numpy(), w.numpy(), k, rtol=DET_TOL,
                      atol=DET_TOL)
    for f in ("mean_L", "mean_l", "S_l"):
        _assert_close(cov[f].numpy(), want_cov[f].numpy(), f, rtol=DET_TOL,
                      atol=DET_TOL)


def test_dropout_mesh_matches_one_process(ranks):
    losses, params = ranks[0]["dropout_dp2"]
    want_losses, want = _tf_run(None, "dropout_dp2")
    _assert_close(losses, want_losses, "loss", **TF_TOL)
    # dropout changes the step: the run without it ends elsewhere
    assert not np.allclose(want_losses, ranks[0]["dp2"][0], rtol=1e-4)
    for k, w in want.items():
        _assert_close(params[k].numpy(), w.numpy(), k, **TF_TOL)


def test_zero1_checkpoint_resumes_in_one_process(ranks):
    results, path = ranks
    _, params = results["dp2_zero1"]
    cfg = _tf_config(zero1=True)
    model, state = train3.build_transformer_state(cfg, device="cpu")
    latest = ckpt.latest_checkpoint(os.path.join(path, "ck"))
    assert latest.endswith("step_000000001")
    state = ckpt.restore_checkpoint(latest, state)
    assert state.step == 1
    state, _ = transformer_train_step(state, _tf_batch(1))
    got = _whole(model)
    for k, w in params.items():
        _assert_close(got[k].numpy(), w.numpy(), k, **TF_TOL)

