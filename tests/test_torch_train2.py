"""Stage 2 (``train2.train``) of the port against the JAX package's, on the
CPU at the tiny size of ``test_torch_detector_train``.

Both runs start from one stage-1 checkpoint: a JAX schedule-free AdamW
state a few random-gradient steps on (so its eval weights differ from its
iterate), saved by JAX's orbax checkpointer and, carried by
``io.from_jax``, by the port's. Each runs one epoch of two iterations, a
streamed batch at ``weight_stream`` 0.5 then a fixdata batch at
``weight_fix`` 2.0, RAdam on ``exponential_decay(lr, steps_per_epoch,
lr_decay)``, once with the detector trained and once ``decoder_only``.

The batches are recorded once from the port's ``DetectorLoader`` (one
spawned worker over tiny shards) and ``FixDataLoader`` (a painted fixdata
directory), and both packages' loaders are replaced by replays of them: the
JAX loader's spawned workers warp with OpenCV or the JAX package's native
library, which a test's patches do not reach, so the two packages'
loaders give other batches (each loader is held against JAX on its own in
``test_torch_detector_data``). The replays check that both runs ask
their loaders for the same shards, batch size, seed, shape and workers.

Both run in f32 (the JAX model built at f32, the port's ``compute_dtype``
f32): bf16 compute rounds differently in the two frameworks.
Tolerances as ``test_torch_detector_train`` states them: parameters, BN
buffers and CoV statistics atol/rtol 1e-4, with its bias exception.
"""
import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from findtextcenternet_tpu import config as jconfig
from findtextcenternet_tpu import models as jmodels
from findtextcenternet_tpu.data import fixdata as jfixdata_mod
from findtextcenternet_tpu.data import loader as jloader_mod
from findtextcenternet_tpu.parallel import make_mesh
from findtextcenternet_tpu.train import checkpoint as jckpt
from findtextcenternet_tpu.train import train2 as jtrain2
from findtextcenternet_tpu_torch import config as tconfig
from findtextcenternet_tpu_torch.data import fixdata as fixdata_mod
from findtextcenternet_tpu_torch.data import loader as loader_mod
from findtextcenternet_tpu_torch.train import checkpoint as ckpt
from findtextcenternet_tpu_torch.train import train2
from findtextcenternet_tpu_torch.train.state import exponential_decay_lr
from test_torch_detector_data import OUT_HW, _fixdata_dir, _write_shards
from test_torch_detector_train import (  # noqa: F401
    FMASK, _assert_state_matches, _jax_variables, _port_state,
    _jstate, no_drop_path, one_torch_thread, zero_grad_bounds)

SEED, BATCH, EPOCHS, STEPS_PER_EPOCH = 3, 2, 1, 2
LR, LR_DECAY = 1e-3, 0.5
WEIGHT_STREAM, WEIGHT_FIX = 0.5, 2.0
STAGE1_STEPS = 3
CASES = {"detector": False, "decoder_only": True}


def _configs(ckpt_dir):
    """The same tiny stage-2 config in both packages (JAX first)."""
    out = []
    for mod in (jconfig, tconfig):
        cfg = mod.Config()
        out.append(dataclasses.replace(
            cfg,
            detector=dataclasses.replace(
                cfg.detector, model_size="tiny", feature_dim=8,
                decoder_mid_dim=32, image_size=OUT_HW,
                fmask_topk_per_sample=FMASK),
            train=dataclasses.replace(
                cfg.train, batch_size=BATCH, learning_rate=LR,
                epochs=EPOCHS, seed=SEED, log_every=1,
                checkpoint_dir=ckpt_dir)))
    return out


@pytest.fixture(scope="module")
def stage1(tmp_path_factory):
    """One stage-1 state as a JAX and a port checkpoint directory, its
    variables, the shards and fixdata directory, and the batches the
    port's loaders make of them. The files (~1 GB) go at the end."""
    root = tmp_path_factory.mktemp("train2")
    model, variables = _jax_variables()
    jstate = _jstate(model, variables)
    rng = np.random.default_rng(11)
    for _ in range(STAGE1_STEPS):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(0.1 * rng.standard_normal(p.shape),
                                  jnp.float32), jstate.params)
        updates, opt = jstate.tx.update(grads, jstate.opt_state,
                                        jstate.params)
        jstate = jstate.replace(step=jstate.step + 1,
                                params=optax.apply_updates(jstate.params,
                                                           updates),
                                opt_state=opt)
    jdir, tdir = str(root / "jax1"), str(root / "port1")
    jckpt.save_checkpoint(jdir, jstate)
    ckpt.save_checkpoint(tdir, _port_state(jstate))

    paths = _write_shards(str(root / "data" / "train%03d.tar"), 6)
    fix = _fixdata_dir(str(root / "fix"))
    n = EPOCHS * STEPS_PER_EPOCH
    it = iter(loader_mod.DetectorLoader(paths, BATCH, num_workers=1,
                                        seed=SEED, out_hw=OUT_HW))
    try:
        stream = [next(it) for _ in range(n)]
    finally:
        it.close()
    fix_it = fixdata_mod.FixDataLoader(fix, BATCH, seed=SEED,
                                       out_hw=OUT_HW).batches()
    yield {"root": root, "jax": jdir, "port": tdir, "shards": paths,
           "fix": fix, "variables": variables,
           "batches": {"stream": stream, "fix": [next(fix_it)
                                                 for _ in range(n)]}}
    shutil.rmtree(root, ignore_errors=True)


def _replay(monkeypatch, loader_mod_, fixdata_mod_, batches, asked):
    """Replace a package's two loaders by replays of ``batches``; record
    what ``train2.train`` asks of them in ``asked``."""
    def copies(name):
        for b in batches[name]:
            yield {k: v.copy() for k, v in b.items()}

    class Stream:
        def __init__(self, shards, batch_size, **kw):
            asked.append(("stream", list(shards), batch_size, kw))

        def __iter__(self):
            return copies("stream")

    class Fix:
        def __init__(self, dirname, batch_size, **kw):
            asked.append(("fix", dirname, batch_size, kw))

        def batches(self):
            return copies("fix")

    monkeypatch.setattr(loader_mod_, "DetectorLoader", Stream)
    monkeypatch.setattr(fixdata_mod_, "FixDataLoader", Fix)


def _kw(stage1, decoder_only):
    return dict(shards=stage1["shards"], steps_per_epoch=STEPS_PER_EPOCH,
                weight_fix=WEIGHT_FIX, weight_stream=WEIGHT_STREAM,
                lr_decay=LR_DECAY, num_workers=1,
                decoder_only=decoder_only)


@pytest.fixture(scope="module")
def jax_runs(stage1, tmp_path_factory):
    """JAX's ``train2.train`` per case (on a one-device mesh, the model at
    f32): {case: (final state, what it asked of its loaders)}, made on
    first use."""
    runs = {}

    def run(case):
        if case not in runs:
            real = jmodels.TextDetectorModel
            asked = []
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jmodels, "TextDetectorModel", lambda **kw: real(
                    **dict(kw, dtype=jnp.float32)))
                _replay(mp, jloader_mod, jfixdata_mod,
                        stage1["batches"], asked)
                out = tmp_path_factory.mktemp(case)
                jcfg, _ = _configs(str(out))
                state = jtrain2.train(
                    stage1["fix"], config=jcfg, init_from=stage1["jax"],
                    mesh=make_mesh(n_data=1, n_model=1,
                                   devices=jax.devices()[:1]),
                    **_kw(stage1, CASES[case]))
                shutil.rmtree(out, ignore_errors=True)
            runs[case] = (state, asked)
        return runs[case]

    return run


def _schedule_count(opt_state) -> int:
    counts = [int(s.count) for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByScheduleState))
        if isinstance(s, optax.ScaleByScheduleState)]
    assert len(counts) == 1, counts
    return counts[0]


@pytest.mark.parametrize("case", list(CASES))
def test_train2_matches_jax(stage1, jax_runs, case, tmp_path):
    """The port's ``train2.train`` against JAX's from the same stage-1
    checkpoint on the same batches: parameters, BN buffers, CoV
    statistics, step count, RAdam's count and learning rate; what each
    asked of its loaders; with ``decoder_only`` the detector's weights are
    stage 1's eval weights."""
    jstate, jasked = jax_runs(case)
    real = train2.build_detector_state
    asked = []

    def f32_state(*a, **kw):
        model, state = real(*a, **kw)
        state.compute_dtype = torch.float32
        return model, state

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train2, "build_detector_state", f32_state)
        _replay(mp, loader_mod, fixdata_mod, stage1["batches"], asked)
        _, tcfg = _configs(str(tmp_path / "result2"))
        state = train2.train(stage1["fix"], config=tcfg,
                             init_from=stage1["port"], device="cpu",
                             **_kw(stage1, CASES[case]))

    assert len(asked) == 2 and asked == jasked
    steps = 2 * EPOCHS * STEPS_PER_EPOCH
    assert state.step == int(jstate.step) == steps
    _assert_state_matches(state, jstate, zero_grad_bounds(
        stage1["variables"], steps, LR))
    count = _schedule_count(jstate.opt_state)
    opt = state.optimizer
    assert opt.count == count == steps
    np.testing.assert_allclose(
        float(opt.lr), float(optax.exponential_decay(
            LR, STEPS_PER_EPOCH, LR_DECAY)(count)), rtol=1e-6)
    assert float(opt.lr) == float(exponential_decay_lr(
        LR, STEPS_PER_EPOCH, LR_DECAY, steps))
    assert os.path.basename(ckpt.latest_checkpoint(
        tcfg.train.checkpoint_dir)) == f"step_{steps:09d}"
    shutil.rmtree(tcfg.train.checkpoint_dir)
    if CASES[case]:
        first = ckpt.load_eval_params(ckpt.latest_checkpoint(
            stage1["port"]))
        for k, p in state.optimizer.params.items():
            if k.startswith("detector."):
                assert torch.equal(p, first[k]), k
