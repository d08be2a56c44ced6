"""The port's detector training (stages 1 and 2) against the JAX package's,
on the CPU at the tiny size (model "tiny", feature_dim 8, decoder_mid 32,
64² images, fmask 8 per image, as ``tests/test_train.py``).

The JAX side's variables are drawn with numpy into the tree that
``jax.eval_shape`` of its ``init`` gives, and carried to the port by
``io.from_jax``; the batches' targets are painted by the port's numpy
``make_target_maps``, so the GT keymaps are mostly exact zeros and the
top-k selection meets ties. Drop path is random in both packages and
their masks cannot agree: the whole module runs with
``STOCHASTIC_DEPTH_PROB`` at 0 on both sides (JAX reads it at trace time);
the port's drop path is tested on its own.

Tolerances: the train-mode forward, BN buffers and train steps atol/rtol
1e-4 (f32 convolution sums in another order, carried through three
optimizer steps); the loss terms rtol 1e-5 and the optimizers and CoV
statistics rtol 1e-6 (the same f32 operations); top-k indices bit-equal.
One exception: a few bias tensors add a per-channel constant that the next
train-mode BatchNorm removes (the backbone's project BNs that feed 1x1
convolutions or the heads' input BNs, the feature head's output conv that
feeds the SimpleDecoder's BN), so their gradient is 0 in exact arithmetic
(below 1e-16 of the largest in float64). Both packages update them by
Adam-normalised f32 rounding noise of either sign, so those tensors are
held within one learning rate a step, the most such updates can differ
over the test's steps, and the BN running means they shift within the
bound that follows (:func:`zero_grad_bounds`).
Each JAX reference is jitted once in a module fixture (its compile
dominates the file's time).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from findtextcenternet_tpu import losses as jlosses
from findtextcenternet_tpu.io.torch_export import export_detector_sd
from findtextcenternet_tpu.models import efficientnet as jeff
from findtextcenternet_tpu.models.detector import TextDetectorModel as JModel
from findtextcenternet_tpu.train.state import (
    create_train_state as jcreate_state, make_schedule_free_adamw)
from findtextcenternet_tpu.train.steps import (
    detector_bn_recalib_step as jrecalib, detector_eval_step as jeval,
    detector_train_step as jtrain_step)
from findtextcenternet_tpu_torch import losses
from findtextcenternet_tpu_torch.data.targets import make_target_maps
from findtextcenternet_tpu_torch.io.from_jax import (
    cov_state_from_jax, detector_train_state_from_jax,
    text_detector_state_from_flax)
from findtextcenternet_tpu_torch.models import efficientnet as teff
from findtextcenternet_tpu_torch.models.batchnorm import BatchNorm2d
from findtextcenternet_tpu_torch.models.detector import (
    TextDetectorModel, topk_fmask)
from findtextcenternet_tpu_torch.train import checkpoint as ckpt
from findtextcenternet_tpu_torch.train.state import (
    RAdam, ScheduleFreeAdamW, TrainState, trainable_parameters)
from findtextcenternet_tpu_torch.train.steps import (
    detector_bn_recalib_step, detector_eval_step, detector_train_step)

B, HW, FMASK = 2, 64, 8
LR, WARMUP, WD = 1e-3, 2, 1e-2
STEPS = 3
TOL = 1e-4
RUNS = {"accum1": dict(accum_steps=1),
        "accum2-scaled-frozen": dict(accum_steps=2, loss_scale=0.5,
                                     freeze_detector=True)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tiny models run on one thread: the lane runs several test
    processes at once, and each torch op spreading over every core makes
    them wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def no_drop_path():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jeff, "STOCHASTIC_DEPTH_PROB", 0.0)
        mp.setattr(teff, "STOCHASTIC_DEPTH_PROB", 0.0)
        yield


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_variables(seed=0):
    """flax-shaped variables drawn with numpy: kernels N(0, 1/fan_in),
    small biases, BN scales near 1, running means near 0 and variances in
    [0.5, 1.5]."""
    model = JModel("tiny", feature_dim=8, decoder_mid_dim=32)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, HW, HW, 3)),
                            jnp.zeros((FMASK,), jnp.int32))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif name in ("bias", "mean"):
            v = 0.1 * rng.standard_normal(shape)
        elif name == "scale":
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            assert name == "var", path
            v = rng.uniform(0.5, 1.5, shape)
        return v.astype(np.float32)

    return model, jax.tree_util.tree_map_with_path(fill, shapes)


def _batch(seed, n=B):
    """Images, and targets painted from 2-5 random boxes an image."""
    rng = np.random.default_rng(seed)
    mh = HW // 4
    labels, ids = [], []
    for _ in range(n):
        k = int(rng.integers(2, 6))
        pos = np.stack([rng.uniform(8, HW - 8, k), rng.uniform(8, HW - 8, k),
                        rng.uniform(6, 20, k), rng.uniform(6, 20, k)], 1)
        codes = np.stack([rng.integers(0x20, 0x3000, k),
                          rng.integers(0, 16, k)], 1)
        keysize, idmap, _ = make_target_maps(pos.astype(np.float32),
                                             codes.astype(np.int32),
                                             (mh, mh))
        lines = (rng.uniform(size=(mh, mh, 2)) > 0.7).astype(np.float32)
        labels.append(np.concatenate([keysize, lines], -1))
        ids.append(idmap)
    return {"image": rng.uniform(0, 1, (n, HW, HW, 3)).astype(np.float32),
            "labelmap": np.stack(labels).astype(np.float32),
            "idmap": np.stack(ids).astype(np.int32)}


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _jstate(model, variables):
    return jcreate_state(model.apply, variables,
                         make_schedule_free_adamw(LR, WARMUP,
                                                  weight_decay=WD),
                         num_cov_losses=9)


def _port_state(jstate):
    """A port TrainState (f32) loaded from a JAX one."""
    model = TextDetectorModel("tiny", feature_dim=8, decoder_mid_dim=32)
    state = TrainState(step=0, model=model.train(),
                       optimizer=ScheduleFreeAdamW(
                           trainable_parameters(model), LR, WARMUP, WD))
    return detector_train_state_from_jax(_np(jstate), state, "tiny")


@pytest.fixture(scope="module")
def ref():
    """The JAX side: variables, and per run the states after each of
    STEPS steps on batches 0..STEPS-1, with their metrics; the eval
    metrics and recalibrated BN statistics after the accum1 run."""
    model, variables = _jax_variables()
    out = {"model": model, "variables": variables, "runs": {}}
    for name, kw in RUNS.items():
        step = jax.jit(lambda s, b, kw=kw: jtrain_step(s, b, fmask_k=FMASK,
                                                       **kw))
        states, metrics = [_jstate(model, variables)], []
        for i in range(STEPS):
            s, m = step(states[-1], _jbatch(_batch(i)))
            states.append(s)
            metrics.append(_np(m))
        out["runs"][name] = (states, metrics)
    last = out["runs"]["accum1"][0][-1]
    b = _jbatch(_batch(99))
    out["eval"] = _np(jax.jit(lambda s, b: jeval(s, b, fmask_k=FMASK))(
        last, b))
    out["recalib"] = _np(jax.jit(lambda s, b: jrecalib(
        s, b, fmask_k=FMASK))(last, b).batch_stats)
    return out


@pytest.fixture(scope="module")
def zero_grad(ref):
    return zero_grad_bounds(ref["variables"], STEPS, LR)


def zero_grad_bounds(variables, steps: int, lr: float) -> dict:
    """``{name: allowed distance}`` after ``steps`` optimizer steps at
    learning rate ``lr`` for the parameters whose gradient is 0 in exact
    arithmetic (below 1e-9 of the largest in a float64 backward of the
    port's model on ``variables``; rounding leaves ~1e-17 there) and for
    the BN running means they shift. Such a parameter is held within
    ``steps * lr``. A running mean that moves by ``r`` times a shift of
    those parameters in one train-mode forward (measured in float64) is
    held within ``TOL + steps * steps * lr * r``: each step's forward
    moves it by at most ``r`` times the parameters' distance."""
    model = TextDetectorModel("tiny", feature_dim=8, decoder_mid_dim=32)
    model.load_state_dict(text_detector_state_from_flax(variables, "tiny"))
    model.double().train()
    b = _batch(0)
    label = torch.from_numpy(b["labelmap"]).double()
    image = torch.from_numpy(b["image"]).double()
    fidx = topk_fmask(label[..., 0], FMASK)
    base = {k: v.clone() for k, v in model.state_dict().items()}
    heat, outs = model(image, fidx)
    m = losses.detector_loss(fidx, label, torch.from_numpy(b["idmap"]),
                             heat, outs)
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(sum(m[k] for k in losses.DETECTOR_LOSS_NAMES),
                                list(params.values()))
    top = max(float(g.abs().max()) for g in grads)
    names = {n for n, g in zip(params, grads)
             if float(g.abs().max()) < 1e-9 * top}
    assert "detector.backbone.features.3.0.block.1.1.bias" in names
    assert len(names) < 10

    def buffers_after(shift):
        model.load_state_dict(base)
        with torch.no_grad():
            for n in names:
                params[n].add_(shift)
            model(image, fidx)
        return {k: v.clone() for k, v in model.state_dict().items()
                if k.endswith("running_mean")}

    shift = 1e-3
    a, c = buffers_after(0.0), buffers_after(shift)
    allowed = {n: steps * lr for n in names}
    for k in a:
        r = float((c[k] - a[k]).abs().max()) / shift
        if r > 1e-9:
            allowed[k] = TOL + steps * steps * lr * r
    return allowed


def _assert_state_matches(state, jstate, zero_grad, tol=TOL):
    want = text_detector_state_from_flax(
        {"params": _np(jstate.params), "batch_stats": _np(jstate.batch_stats)},
        "tiny")
    got = state.model.state_dict()
    assert set(got) == set(want)
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=tol,
                                   atol=zero_grad.get(k, tol), err_msg=k)
    jcov = cov_state_from_jax(_np(jstate.cov))
    assert int(state.cov.t) == int(jcov.t)
    for f in ("mean_L", "mean_l", "S_l"):
        np.testing.assert_allclose(getattr(state.cov, f).numpy(),
                                   getattr(jcov, f).numpy(), rtol=tol,
                                   atol=tol, err_msg=f)
    assert state.step == int(jstate.step)


def _assert_metrics_match(got, want, tol=TOL):
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(float(got[k]), float(w), rtol=tol,
                                   atol=tol, err_msg=k)


# ---------------------------------------------------------------------
# model
# ---------------------------------------------------------------------

def test_state_dict_keys_and_values_match_torch_export(ref):
    want = export_detector_sd(ref["variables"], "tiny")
    sd = text_detector_state_from_flax(ref["variables"], "tiny")
    model = TextDetectorModel("tiny", feature_dim=8, decoder_mid_dim=32)
    assert set(model.state_dict()) == set(sd) == set(want)
    model.load_state_dict(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(v.numpy(), want[k])


def test_train_forward_and_bn_buffers_match_jax(ref):
    """One train-mode forward of the same weights: heatmap, the
    SimpleDecoder's logits at the top-k pixels, and every BN buffer after
    it (flax's running variance)."""
    b = _batch(5)
    fidx = topk_fmask(torch.from_numpy(b["labelmap"][..., 0]), FMASK)
    (jheat, jouts), upd = jax.jit(lambda v, x, f: ref["model"].apply(
        v, x, f, True, mutable=["batch_stats"],
        rngs={"dropout": jax.random.PRNGKey(0)}))(
        ref["variables"], jnp.asarray(b["image"]), jnp.asarray(fidx.numpy()))
    model = TextDetectorModel("tiny", feature_dim=8, decoder_mid_dim=32)
    model.load_state_dict(text_detector_state_from_flax(ref["variables"],
                                                        "tiny"))
    with torch.no_grad():
        heat, outs = model.train()(torch.from_numpy(b["image"]), fidx)
    np.testing.assert_allclose(heat.numpy(), np.asarray(jheat), rtol=TOL,
                               atol=TOL)
    for o, jo in zip(outs, jouts):
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=TOL,
                                   atol=TOL)
    want = text_detector_state_from_flax(
        {"params": ref["variables"]["params"],
         "batch_stats": _np(upd["batch_stats"])}, "tiny")
    got = model.state_dict()
    for k in want:
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       rtol=TOL, atol=TOL, err_msg=k)


@pytest.mark.parametrize("case", ["zeros", "plateaus", "all-equal"])
def test_topk_fmask_ties_equal_lax_top_k(case):
    """Maps full of ties: indices bit-equal to ``lax.top_k`` (lower index
    first among equal values)."""
    rng = np.random.default_rng(3)
    keymap = np.zeros((3, 16, 16), np.float32)
    if case == "zeros":
        keymap[0, 4, 4] = 1.0
        keymap[2, 9, 3] = 0.5
    elif case == "plateaus":
        keymap[:] = rng.integers(0, 4, keymap.shape) / 4.0
    else:
        keymap[:] = 0.25
    for k in (1, 8, 100):
        want = np.asarray(jax.lax.top_k(jnp.asarray(keymap).reshape(-1),
                                        3 * k)[1])
        got = topk_fmask(torch.from_numpy(keymap), k).numpy()
        np.testing.assert_array_equal(got, want)


def test_drop_path_keep_rate_scaling_and_eval_identity():
    """Row mode: one draw a sample, mask ``floor(keep + u)``, kept rows
    scaled by ``1/keep``; the identity in eval mode."""
    torch.manual_seed(0)
    bb = teff.EfficientNetV2("tiny")
    sd = [m for m in bb.modules() if isinstance(m, teff.StochasticDepth)][-1]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(teff, "STOCHASTIC_DEPTH_PROB", 0.5)
        rate = sd.rate
        assert rate == 0.5 * sd.block_id / sd.total_blocks > 0
        x = torch.randn(64, 3, 4, 4)
        bb.set_drop_path_noise(torch.Generator().manual_seed(1), 64, "cpu")
        u = sd.noise
        assert u.shape == (64,)
        bb.train()
        y = sd(x)
        keep = 1.0 - rate
        for i in range(64):
            if u[i] + keep >= 1.0:
                torch.testing.assert_close(y[i], x[i] / keep)
            else:
                assert torch.all(y[i] == 0)
        kept = (torch.floor(keep + u) == 1).float().mean()
        assert 0 < kept < 1
        bb.eval()
        assert sd(x) is x


def test_bn_running_variance_follows_flax():
    """The buffer moves towards the biased batch variance (momentum 0.1)."""
    x = torch.randn(2, 3, 4, 4) * 3 + 1
    bn = BatchNorm2d(3, eps=1e-3).train()
    bn.running_var.fill_(2.0)
    bn(x)
    var = x.transpose(0, 1).reshape(3, -1).var(dim=1, unbiased=False)
    torch.testing.assert_close(bn.running_var, 0.9 * 2.0 + 0.1 * var,
                               rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(bn.running_mean,
                               0.1 * x.mean(dim=(0, 2, 3)))


# ---------------------------------------------------------------------
# losses and optimizers
# ---------------------------------------------------------------------

def test_detector_loss_matches_jax():
    rng = np.random.default_rng(4)
    b = _batch(7, n=2)
    heat = rng.standard_normal((2, 16, 16, 9)).astype(np.float32) * 2
    fidx = topk_fmask(torch.from_numpy(b["labelmap"][..., 0]), FMASK)
    outs = [rng.standard_normal((2 * FMASK, m)).astype(np.float32)
            for m in (1091, 1093, 1097)]
    # the first selected pixel (a center, key 1.0, a real id) is
    # predicted exactly, so `correct` is not trivially 0
    gid = int(b["idmap"][..., 0].reshape(-1)[int(fidx[0])])
    assert gid > 0
    for o, m in zip(outs, (1091, 1093, 1097)):
        o[0, gid % m] = 50.0
    want = jax.jit(jlosses.detector_loss)(
        jnp.asarray(fidx.numpy()), jnp.asarray(b["labelmap"]),
        jnp.asarray(b["idmap"]), jnp.asarray(heat),
        [jnp.asarray(o) for o in outs])
    got = losses.detector_loss(
        fidx, torch.from_numpy(b["labelmap"]), torch.from_numpy(b["idmap"]),
        torch.from_numpy(heat), [torch.from_numpy(o) for o in outs])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=1e-5, err_msg=k)
    assert int(got["correct"]) == int(want["correct"]) >= 1
    assert int(got["total"]) == int(want["total"])


def test_cov_apply_matches_jax_over_five_steps():
    rng = np.random.default_rng(5)
    jstate, tstate = jlosses.cov_init(9), losses.cov_init(9)
    for _ in range(5):
        ls = rng.uniform(0.1, 3.0, 9).astype(np.float32)
        jw, jstate, ja = jlosses.cov_apply(jstate, [jnp.asarray(v)
                                                    for v in ls])
        tw, tstate, ta = losses.cov_apply(tstate, [torch.tensor(v)
                                                   for v in ls])
        np.testing.assert_allclose(float(tw), float(jw), rtol=1e-6)
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-6)
        want = cov_state_from_jax(_np(jstate))
        assert int(tstate.t) == int(want.t)
        for f in ("mean_L", "mean_l", "S_l"):
            np.testing.assert_allclose(getattr(tstate, f).numpy(),
                                       getattr(want, f).numpy(), rtol=1e-6)


def _tree(rng):
    return {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": rng.standard_normal((5,)).astype(np.float32)}


def _run_optimizer(tx, opt, tree, rng, eval_params):
    jparams = {k: jnp.asarray(v) for k, v in tree.items()}
    jopt = tx.init(jparams)
    update = jax.jit(tx.update)
    for step in range(10):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32)
                 for k, v in tree.items()}
        upd, jopt = update({k: jnp.asarray(g) for k, g in grads.items()},
                           jopt, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams, upd)
        opt.step({k: torch.from_numpy(g) for k, g in grads.items()})
        jeval_ = _np(eval_params(jopt, jparams))
        teval = opt.eval_params()
        for k in tree:
            np.testing.assert_allclose(opt.params[k].numpy(),
                                       np.asarray(jparams[k]), rtol=1e-6,
                                       err_msg=f"params {k} step {step}")
            np.testing.assert_allclose(teval[k].numpy(), jeval_[k],
                                       rtol=1e-6,
                                       err_msg=f"eval {k} step {step}")


@pytest.mark.parametrize("warmup,wd", [(4, 0.0), (4, 1e-2), (0, 1e-2)])
def test_schedule_free_adamw_matches_optax(warmup, wd):
    """Ten steps across the warmup, with and without weight decay; optax
    keeps the learning rate at 0 when ``warmup_steps`` is 0, and so does
    the port."""
    rng = np.random.default_rng(6)
    tree = _tree(rng)
    opt = ScheduleFreeAdamW({k: torch.from_numpy(v.copy())
                             for k, v in tree.items()}, 2.5e-3, warmup, wd)
    _run_optimizer(make_schedule_free_adamw(2.5e-3, warmup, weight_decay=wd),
                   opt, tree, rng, optax.contrib.schedule_free_eval_params)


def test_radam_exponential_decay_matches_optax():
    """Stage 2's optimizer over ten steps, three decay periods; RAdam's
    rectification switches on at step 6."""
    rng = np.random.default_rng(7)
    tree = _tree(rng)
    opt = RAdam({k: torch.from_numpy(v.copy()) for k, v in tree.items()},
                1e-3, 3, 0.5)
    tx = optax.radam(optax.exponential_decay(1e-3, 3, 0.5))
    _run_optimizer(tx, opt, tree, rng, lambda s, p: p)


# ---------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------

@pytest.mark.parametrize("run", list(RUNS))
def test_detector_train_step_matches_jax(ref, zero_grad, run):
    """Three steps from the same state on the same batches: metrics,
    parameters, BN buffers and CoV statistics after each. The second run
    covers micro-batches (BN and CoV threaded through them), the loss
    scale and the frozen detector together: one JAX compile each."""
    states, metrics = ref["runs"][run]
    state = _port_state(states[0])
    for i in range(STEPS):
        state, m = detector_train_step(state, _batch(i), fmask_k=FMASK,
                                       **RUNS[run])
        _assert_metrics_match(m, metrics[i])
        _assert_state_matches(state, states[i + 1], zero_grad)


def test_jax_state_continues_in_port(ref, zero_grad):
    """The JAX state after one step, loaded into the port, takes the same
    next two steps as JAX."""
    states, metrics = ref["runs"]["accum1"]
    state = _port_state(states[1])
    assert state.step == 1 and state.optimizer.step_count == 2
    for i in (1, 2):
        state, m = detector_train_step(state, _batch(i), fmask_k=FMASK)
        _assert_metrics_match(m, metrics[i])
        _assert_state_matches(state, states[i + 1], zero_grad)


def test_eval_and_bn_recalib_steps_match_jax(ref):
    states, _ = ref["runs"]["accum1"]
    state = _port_state(states[-1])
    b = _batch(99)
    params = {k: p.detach().clone() for k, p in
              state.optimizer.params.items()}
    _assert_metrics_match(detector_eval_step(state, b, fmask_k=FMASK),
                          ref["eval"])
    detector_bn_recalib_step(state, b, fmask_k=FMASK)
    want = text_detector_state_from_flax(
        {"params": _np(states[-1].params), "batch_stats": ref["recalib"]},
        "tiny")
    got = state.model.state_dict()
    for k, w in want.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=TOL,
                                       atol=TOL, err_msg=k)
    for k, p in state.optimizer.params.items():      # only BN buffers move
        assert torch.equal(p, params[k]), k
    assert state.model.training


def test_remat_step_equals_plain_step(ref):
    """``remat`` recomputes each block and head in the backward pass: the
    same gradients, and the BN buffers updated once."""
    states, _ = ref["runs"]["accum1"]
    plain, remat = _port_state(states[0]), _port_state(states[0])
    for m in remat.model.modules():
        if hasattr(m, "remat"):
            m.remat = True
    for s in (plain, remat):
        detector_train_step(s, _batch(0), fmask_k=FMASK)
        detector_train_step(s, _batch(1), fmask_k=FMASK)
    a, b = plain.model.state_dict(), remat.model.state_dict()
    for k in a:
        torch.testing.assert_close(b[k], a[k], rtol=1e-5, atol=1e-6,
                                   msg=k)


def test_checkpoint_restores_the_exact_state(ref, tmp_path):
    states, _ = ref["runs"]["accum1"]
    a = _port_state(states[0])
    detector_train_step(a, _batch(0), fmask_k=FMASK)
    path = ckpt.save_checkpoint(str(tmp_path), a)
    assert os.path.basename(path) == "step_000000001"
    b = ckpt.restore_checkpoint(path, _port_state(states[0]))
    assert b.step == 1 and int(b.cov.t) == int(a.cov.t)
    for s in (a, b):
        detector_train_step(s, _batch(1), fmask_k=FMASK)
    for k, v in a.model.state_dict().items():
        assert torch.equal(b.model.state_dict()[k], v), k
    sd = ckpt.load_eval_params(path)
    assert set(sd) == set(a.model.state_dict())
