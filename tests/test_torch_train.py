"""The port's stage-3 training path against the JAX package's, on the CPU.

Same numpy inputs and the same weights (through ``io.from_jax``) on both
sides. Tolerances: the loss atol 1e-6 (one f32 reduction order); the
optimizer rtol 1e-6 (the same f32 operations; its scalar recurrences round
as XLA's do); train steps atol/rtol 1e-4 (f32 matmul and LayerNorm sums in
another order, carried through the network and up to three optimizer
steps); the attention backward rtol/atol 1e-5, as
``tests/test_fused_attention.py`` holds the JAX kernel. The JAX side's
fused route runs its Pallas kernels in interpret mode, as the JAX tests do.
"""
import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from findtextcenternet_tpu import config as jconfig
from findtextcenternet_tpu import losses as jlosses
from findtextcenternet_tpu.data import transformer_data as jdata
from findtextcenternet_tpu.models import transformer as jt
from findtextcenternet_tpu.ops import attention as jattention
from findtextcenternet_tpu.train.state import (
    create_train_state as jcreate_state, make_schedule_free_radam)
from findtextcenternet_tpu.train.steps import (
    transformer_train_step as jtrain_step)
from findtextcenternet_tpu_torch import config as tconfig
from findtextcenternet_tpu_torch import losses
from findtextcenternet_tpu_torch.data import transformer_data as tdata
from findtextcenternet_tpu_torch.io.from_jax import (
    schedule_free_state_from_optax, transformer_state_from_flax)
from findtextcenternet_tpu_torch.models import transformer as tt
from findtextcenternet_tpu_torch.ops import attention
from findtextcenternet_tpu_torch.train import checkpoint as ckpt
from findtextcenternet_tpu_torch.train import train3
from findtextcenternet_tpu_torch.train.state import (
    RADAM_B1, ScheduleFreeRAdam, create_train_state)
from findtextcenternet_tpu_torch.train.steps import (
    batch_to_device, loss_and_grads, transformer_eval_step,
    transformer_train_step)

# dims as in tests/test_torch_transformer.py
JDIMS = jt.TransformerDims(enc_input_dim=20, embed_dim=32, head_num=4,
                           enc_block_num=2, dec_block_num=2,
                           max_enc_seq_len=16, max_dec_seq_len=16)
TDIMS = tt.TransformerDims(**{f: getattr(JDIMS, f) for f in
                              JDIMS.__dataclass_fields__})
LR = 2.5e-3
STEPS = 3


def _batch(seed, b=3):
    rng = np.random.default_rng(seed)
    enc = rng.standard_normal((b, 16, 20)).astype(np.float32)
    enc[1:2, 9:] = 0.0                 # padded tail rows (masked keys)
    true = rng.integers(4, 70000, (b, 16)).astype(np.int32)
    true[2:3, 11:] = 0                 # PAD targets carry no loss
    inp = np.where(rng.uniform(size=(b, 16)) < 0.5, 3, true).astype(np.int32)
    return {"encoder_input": enc, "decoder_input": inp, "decoder_true": true}


@functools.lru_cache(maxsize=None)
def _jax_variables():
    """The JAX Transformer's initial variables as numpy (not mutated)."""
    v = jax.jit(jt.Transformer(JDIMS).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 20)),
        jnp.zeros((1, 16), jnp.int32))
    return jax.tree_util.tree_map(np.asarray, v)


def _jax_state(variables, attn_impl):
    model = jt.Transformer(JDIMS, attn_impl=attn_impl)
    return jcreate_state(model.apply, variables, make_schedule_free_radam(LR))


def _port_state(variables, attn_impl, dims=TDIMS):
    model = tt.Transformer(dims, attn_impl=attn_impl)
    model.load_state_dict(transformer_state_from_flax(variables, dims))
    return create_train_state(model, LR)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_runs():
    """Per route: the JAX package's losses and params after each of STEPS
    train steps on batches 0..STEPS-1, its state after the last, the jitted
    step, and the loss and gradients of the first step (on port keys). The
    gradients are read back from RAdam's first moment after one step,
    mu = (1 - b1) g, so they are the ones the JAX step took."""
    variables = _jax_variables()
    runs = {}
    for impl in ("xla", "fused"):
        state = _jax_state(variables, impl)
        step = jax.jit(jtrain_step)
        losses_, params = [], []
        for i in range(STEPS):
            b = {k: jnp.asarray(v) for k, v in _batch(i).items()}
            state, m = step(state, b)
            losses_.append(float(m["loss"]))
            params.append(_np(state.params))
            if i == 0:
                mu = _np(state.opt_state.base_optimizer_state[0].mu)
                grads0 = transformer_state_from_flax(
                    {"params": jax.tree_util.tree_map(
                        lambda x: x / np.float32(1.0 - RADAM_B1), mu)},
                    TDIMS, key_tables=False)
        runs[impl] = (losses_, params, state, step, (losses_[0], grads0))
    return variables, runs


def _assert_params_match(model, jparams, tol):
    want = transformer_state_from_flax({"params": jparams}, TDIMS)
    got = model.state_dict()
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=tol,
                                   atol=tol, err_msg=k)


def test_transformer_loss_matches_jax():
    rng = np.random.default_rng(0)
    logits = [rng.standard_normal((3, 16, m)).astype(np.float32) * 3
              for m in (1091, 1093, 1097)]
    true = rng.integers(0, 70000, (3, 16)).astype(np.int32)
    mask = rng.uniform(size=(3, 16)) < 0.4
    # one position predicted exactly, so `correct` is not trivially 0
    for lg, m in zip(logits, (1091, 1093, 1097)):
        lg[0, 0, true[0, 0] % m] = 50.0
    mask[0, 0] = True
    want = jlosses.transformer_loss([jnp.asarray(x) for x in logits],
                                    jnp.asarray(true), jnp.asarray(mask))
    got = losses.transformer_loss([torch.from_numpy(x) for x in logits],
                                  torch.from_numpy(true),
                                  torch.from_numpy(mask))
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               atol=1e-6, rtol=0)
    assert int(got["correct"]) == int(want["correct"]) >= 1
    assert int(got["total"]) == int(want["total"])


def test_schedule_free_radam_matches_optax_across_rectification():
    """Ten steps: RAdam's ro passes 5 at step 6, so both branches run."""
    rng = np.random.default_rng(1)
    tree = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": rng.standard_normal((5,)).astype(np.float32)}
    tx = make_schedule_free_radam(LR)
    jparams = {k: jnp.asarray(v) for k, v in tree.items()}
    jopt = tx.init(jparams)
    update = jax.jit(tx.update)
    tparams = {k: torch.from_numpy(v.copy()) for k, v in tree.items()}
    opt = ScheduleFreeRAdam(tparams, LR)
    for step in range(10):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32)
                 for k, v in tree.items()}
        upd, jopt = update({k: jnp.asarray(g) for k, g in grads.items()},
                           jopt, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams, upd)
        opt.step({k: torch.from_numpy(g) for k, g in grads.items()})
        jeval = _np(optax.contrib.schedule_free_eval_params(jopt, jparams))
        teval = opt.eval_params()
        for k in tree:
            np.testing.assert_allclose(tparams[k].numpy(),
                                       np.asarray(jparams[k]), rtol=1e-6,
                                       err_msg=f"params {k} step {step}")
            np.testing.assert_allclose(teval[k].numpy(), jeval[k],
                                       rtol=1e-6,
                                       err_msg=f"eval {k} step {step}")
    assert opt.count == int(jopt.base_optimizer_state[0].count) == 10
    assert opt.step_count == int(jopt.step_count) == 11


@pytest.mark.parametrize("attn_impl", ["xla", "fused"])
def test_train_steps_match_jax(jax_runs, attn_impl, monkeypatch):
    """Steps 1 and 3 of transformer_train_step against the JAX package's,
    from the same weights and batches; the fused route goes through the
    FusedAttention function (its backward runs the plain version here)."""
    bwd_calls = []
    real_bwd = attention.attention_bwd_plain
    monkeypatch.setattr(attention, "attention_bwd_plain",
                        lambda *a: bwd_calls.append(1) or real_bwd(*a))
    variables, runs = jax_runs
    jlosses_, jparams, _, _, _ = runs[attn_impl]
    state = _port_state(variables, attn_impl)
    for i in range(STEPS):
        state, m = transformer_train_step(state, _batch(i))
        np.testing.assert_allclose(float(m["loss"]), jlosses_[i], rtol=1e-4,
                                   atol=1e-4)
        if i in (0, STEPS - 1):
            _assert_params_match(state.model, jparams[i], 1e-4)
    assert state.step == STEPS
    sites = TDIMS.enc_block_num + 2 * TDIMS.dec_block_num
    assert len(bwd_calls) == (STEPS * sites if attn_impl == "fused" else 0)


@pytest.mark.parametrize("attn_impl", ["xla", "fused"])
def test_loss_and_grads_match_jax_grad(jax_runs, attn_impl):
    """The port's gradients of batch 0 against the JAX train step's, at the
    same initial weights, tensor by tensor (the JAX tree mapped onto port
    keys by io.from_jax): the norm of the difference within 1e-5 of the
    gradient's norm."""
    variables, runs = jax_runs
    jloss, want = runs[attn_impl][4]
    state = _port_state(variables, attn_impl)
    grads, m = loss_and_grads(state, batch_to_device(_batch(0), "cpu"))
    np.testing.assert_allclose(float(m["loss"]), jloss, rtol=1e-5)
    assert set(grads) == set(want)
    for k, w in want.items():
        diff = float(torch.linalg.vector_norm(grads[k] - w))
        norm = float(torch.linalg.vector_norm(w))
        assert norm > 0 and diff <= 1e-5 * norm, (k, diff, norm)


def test_continue_a_jax_state_in_the_port(jax_runs):
    """Params and schedule-free RAdam state of the JAX run after STEPS
    steps carried across; four more steps (across ro >= 5) on both sides."""
    variables, runs = jax_runs
    _, _, jstate, step, _ = runs["xla"]
    state = _port_state({"params": _np(jstate.params)}, "xla")
    state.optimizer.load_state_dict(
        schedule_free_state_from_optax(_np(jstate.opt_state), TDIMS))
    state.step = int(jstate.step)
    for i in range(STEPS, STEPS + 4):
        jstate, jm = step(jstate, {k: jnp.asarray(v)
                                   for k, v in _batch(i).items()})
        state, m = transformer_train_step(state, _batch(i))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-4, atol=1e-4)
    assert state.optimizer.count == STEPS + 4
    _assert_params_match(state.model, _np(jstate.params), 1e-4)
    jeval = transformer_state_from_flax(
        {"params": _np(jstate.eval_params())}, TDIMS)
    for k, v in state.eval_state_dict().items():
        np.testing.assert_allclose(v.numpy(), jeval[k].numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=k)


def test_accum_steps_equivalence():
    """accum_steps=2 on a batch of two identical samples makes the same
    update as the full-batch step (after tests/test_train.py:90-117)."""
    variables = _jax_variables()
    one = _batch(5, b=1)
    batch = {k: np.repeat(v, 2, axis=0) for k, v in one.items()}
    s1, m1 = transformer_train_step(_port_state(variables, "xla"), batch)
    s2, m2 = transformer_train_step(_port_state(variables, "xla"), batch,
                                    accum_steps=2)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-5)
    for (k, a), b in zip(s1.model.state_dict().items(),
                         s2.model.state_dict().values()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                   atol=1e-6, err_msg=k)
    with pytest.raises(ValueError):
        transformer_train_step(_port_state(variables, "xla"), _batch(0),
                               accum_steps=2)


def _attn_inputs(seed, b=2, tq=16, tk=24, h=2, hd=8, lengths=(20, 24)):
    rng = np.random.default_rng(seed)
    q, w = (rng.standard_normal((b, tq, h, hd)).astype(np.float32)
            for _ in range(2))
    k, v = (rng.standard_normal((b, tk, h, hd)).astype(np.float32)
            for _ in range(2))
    enc = np.ones((b, tk, 3), np.float32)
    for i, n in enumerate(lengths):
        enc[i, n:] = 0.0
    return q, k, v, w, tt.make_key_mask(torch.from_numpy(enc))


def test_fused_function_grads_match_autograd_of_plain():
    """After tests/test_fused_attention.py:199-223; masked keys get
    exact-zero gradients, a fully masked batch row NaN on both sides."""
    q, k, v, w, mask = _attn_inputs(6, b=3, lengths=(20, 24, 0))

    def grads(fn):
        ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        out = fn(*ts, mask)
        torch.sum(out * torch.from_numpy(w)).backward()
        return [t.grad.numpy() for t in ts]

    g_fused = grads(attention.fused_attention)
    g_plain = grads(attention.attention_plain)
    for a, b in zip(g_fused, g_plain):
        np.testing.assert_allclose(a[:2], b[:2], rtol=1e-5, atol=1e-5)
        assert np.isnan(a[2]).all() and np.isnan(b[2]).all()
    dq, dk, dv = g_fused
    assert (dk[0, 20:] == 0).all() and (dv[0, 20:] == 0).all()


def test_attention_bwd_plain_matches_jax_kernel():
    q, k, v, w, mask = _attn_inputs(7)
    jmask = jnp.asarray(mask.numpy()).reshape(2, 1, 24)
    tr = lambda x: jnp.asarray(np.transpose(x, (0, 2, 1, 3)))  # noqa: E731
    want = jattention._fused_bwd_bhtd(tr(q), tr(k), tr(v), jmask, tr(w),
                                      interpret=True)
    got = attention.attention_bwd_plain(
        *(torch.from_numpy(x) for x in (q, k, v)), mask, torch.from_numpy(w))
    for g, j in zip(got, want):
        np.testing.assert_allclose(
            g.numpy(), np.transpose(np.asarray(j), (0, 2, 1, 3)), rtol=1e-5,
            atol=1e-5)


def test_dropout_training_takes_the_plain_path(monkeypatch):
    """With dropout > 0 a fused-route site trains through the einsum path
    (dropout on the attention weights), bit for bit the xla route's result
    under the same generator; the masks follow (dropout_seed, step)."""
    calls = []
    real = attention.fused_attention
    monkeypatch.setattr(attention, "fused_attention",
                        lambda *a: calls.append(1) or real(*a))
    dims = dataclasses.replace(TDIMS, dropout=0.1)
    variables = _jax_variables()
    runs = {}
    for impl in ("xla", "fused"):
        state = _port_state(variables, impl, dims)
        state, m = transformer_train_step(state, _batch(0), dropout_seed=3)
        runs[impl] = (float(m["loss"]), state.model.state_dict())
    assert not calls
    assert np.isfinite(runs["xla"][0]) and runs["xla"][0] == runs["fused"][0]
    for k, a in runs["xla"][1].items():
        torch.testing.assert_close(a, runs["fused"][1][k], rtol=0, atol=0)
    # another seed draws other masks; eval mode draws none
    state = _port_state(variables, "xla", dims)
    _, m = transformer_train_step(state, _batch(0), dropout_seed=4)
    assert float(m["loss"]) != runs["xla"][0]
    m1 = transformer_eval_step(state, _batch(1))
    m2 = transformer_eval_step(state, _batch(1))
    assert float(m1["loss"]) == float(m2["loss"])


def _realdata_entry(mod):
    rng = np.random.default_rng(11)
    feats = rng.standard_normal((12, 100)).astype(np.float32)
    boxes = []
    for i, (sub, text) in enumerate(
            [(0, "本"), (2, "漢"), (2, "字"), (6, "か"), (6, "ん"), (8, "じ"),
             (0, "a"), (1, "縦"), (17, "点"), (0, "文"), (0, "章"),
             (0, "。")]):
        boxes.append({"boxid": i, "blockid": i // 6, "lineid": i // 3,
                      "subtype": sub, "text": text})
    return mod.build_realdata_entry(feats, boxes)


def test_transformer_dataset_batches_bit_equal_to_jax():
    codes = [ord(c) for c in "あいうえお漢字本文"] + list(range(0x4E00, 0x4E40))
    batches = {}
    for name, mod in (("jax", jdata), ("port", tdata)):
        bank = mod.FeatureBank.synthetic(codes, seed=2)
        ds = mod.TransformerDataset(bank, real_data=[_realdata_entry(mod)],
                                    noise_ratio=0.5, seed=3, real_ratio=1)
        it = ds.batches(6)
        batches[name] = [next(it) for _ in range(3)]
    for bj, bt in zip(batches["jax"], batches["port"]):
        for k in bj:
            np.testing.assert_array_equal(bt[k], bj[k], err_msg=k)
    # the mix reached both the replay and the generated sources
    assert len({b["encoder_input"].tobytes() for b in batches["port"]}) == 3


def test_checkpoint_roundtrip_resumes_exactly(tmp_path):
    variables = _jax_variables()
    state = _port_state(variables, "xla")
    for i in range(2):
        state, _ = transformer_train_step(state, _batch(i))
    path = ckpt.save_checkpoint(str(tmp_path / "ck"), state,
                                tconfig.Config())
    assert path.endswith("step_000000002")
    assert ckpt.latest_checkpoint(str(tmp_path / "ck")) == path
    assert os.path.exists(tmp_path / "ck" / "config.json")

    fresh = create_train_state(tt.Transformer(TDIMS), LR)
    fresh = ckpt.restore_checkpoint(path, fresh)
    assert fresh.step == 2
    for s in (state, fresh):
        transformer_train_step(s, _batch(2))
    for k, a in state.model.state_dict().items():
        torch.testing.assert_close(fresh.model.state_dict()[k], a, rtol=0,
                                   atol=0)
    for k, a in state.eval_state_dict().items():
        torch.testing.assert_close(fresh.eval_state_dict()[k], a, rtol=0,
                                   atol=0)
    # the saved eval weights load into an inference model
    m = tt.Transformer(TDIMS)
    m.load_state_dict(ckpt.load_variables(path))
    # keep 3
    for _ in range(3):
        transformer_train_step(state, _batch(0))
        ckpt.save_checkpoint(str(tmp_path / "ck"), state)
    assert sorted(os.listdir(tmp_path / "ck")) == [
        "config.json", "step_000000004", "step_000000005", "step_000000006"]


def test_mirrored_key_tables_track_the_query_tables():
    """The self-attention key tables are outside the optimizer (JAX's
    parameter set); the eval (export) weights carry each query table in
    its key table after training moved the query tables."""
    state = _port_state(_jax_variables(), "xla")
    names = set(state.optimizer.params)
    assert "encoder.blocks.0.mha.pos_emb_k.encoding" not in names
    assert "decoder.blocks.0.cross_attn.pos_emb_k.encoding" in names
    assert names == set(transformer_state_from_flax(
        {"params": _jax_variables()["params"]}, TDIMS, key_tables=False))
    q0 = state.optimizer.params["encoder.blocks.1.mha.pos_emb_q.encoding"]
    q0 = q0.detach().clone()
    transformer_train_step(state, _batch(0))
    ev = state.eval_state_dict()
    for pre in ("encoder.blocks.1.mha", "decoder.blocks.0.self_attn"):
        torch.testing.assert_close(ev[f"{pre}.pos_emb_k.encoding"],
                                   ev[f"{pre}.pos_emb_q.encoding"], rtol=0,
                                   atol=0)
    assert not torch.equal(ev["encoder.blocks.1.mha.pos_emb_q.encoding"], q0)


def _tiny_config():
    """Config() with the 32-d, 4-head, 1+1-block Transformer over 16
    tokens (the JAX tests' training size)."""
    cfg = tconfig.Config()
    return dataclasses.replace(cfg, transformer=dataclasses.replace(
        cfg.transformer, embed_dim=32, head_num=4, enc_block_num=1,
        dec_block_num=1, max_enc_seq_len=16, max_dec_seq_len=16))


def _tiny_train_config(tmp_path, log_every=1):
    cfg = _tiny_config()
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, batch_size=2, epochs=1, log_every=log_every,
        checkpoint_dir=str(tmp_path / "ck")))


def test_train3_driver_two_steps_on_a_synthetic_bank(tmp_path):
    cfg = _tiny_train_config(tmp_path)
    state = train3.train(config=cfg, steps_per_epoch=2, val_steps=2,
                         synthetic_bank=True, device="cpu")
    assert state.step == 2
    with open(tmp_path / "ck" / "logs" / "log.jsonl") as f:
        recs = [json.loads(line) for line in f]
    train_recs = [r for r in recs if r.get("prefix") == "train"]
    assert [r["step"] for r in train_recs] == [1, 2]
    assert all(np.isfinite(r["loss"]) and "step_time_ms" in r
               for r in train_recs)
    assert any(r.get("prefix") == "val" for r in recs)
    assert any(r.get("tag") == "sample" for r in recs)
    assert ckpt.latest_checkpoint(cfg.train.checkpoint_dir).endswith(
        "step_000000002")
    # a second run resumes at the end and trains no further
    again = train3.train(config=cfg, steps_per_epoch=2, val_steps=1,
                         synthetic_bank=True, device="cpu")
    assert again.step == 2


def test_train3_cli_on_the_cpu(tmp_path, capsys, monkeypatch):
    """The CLI's flags reach the driver; the model is cut to the tiny
    size through the defaults the CLI starts from."""
    monkeypatch.setattr(train3, "Config", _tiny_config)
    assert train3.main(["--synthetic-bank", "--device", "cpu",
                        "--batch-size=2", "--steps-per-epoch=1",
                        "--epochs=1", "--accum=2",
                        f"--checkpoint-dir={tmp_path / 'ck'}"]) == 0
    assert "[val step 1]" in capsys.readouterr().out
    assert os.path.exists(tmp_path / "ck" / "logs" / "log.jsonl")
    with open(tmp_path / "ck" / "config.json") as f:
        saved = json.load(f)
    assert saved["train"]["batch_size"] == 2
    assert saved["train"]["accum_steps"] == 2


def test_build_state_resolves_auto_to_the_einsum_on_the_cpu():
    cfg = _tiny_config()
    assert cfg.transformer.attn_impl == "auto"
    model, state = train3.build_transformer_state(cfg, device="cpu")
    assert {m.attn_impl for m in model.modules()
            if isinstance(m, tt.MultiheadAttn)} == {"xla"}
    assert state.step == 0 and model.training


def test_jax_default_config_loads_in_the_port():
    cfg = tconfig.config_from_json(jconfig.to_json(jconfig.Config()))
    assert cfg.transformer.attn_impl == "auto"
    assert tconfig.to_dict(cfg) == jconfig.to_dict(jconfig.Config())
    assert tconfig.resolve_attn_impl("auto", "cpu") == "xla"
    assert tconfig.resolve_attn_impl("auto", "cuda:0") == "fused"
    assert tconfig.resolve_attn_impl("fused", "cpu") == "fused"
    with pytest.raises(ValueError):
        tconfig.TransformerConfig(attn_impl="flash")
    with pytest.raises(ValueError):
        tconfig.InferenceConfig(decode_attention="auto")
