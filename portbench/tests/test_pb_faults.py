"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card is skipped and the rest of a run is driven at a
tiny size on the CPU, the program broken where it produces its answer.

Serving: a served token altered in the decode; a peak's score altered;
the detector's heatmap shifted. Training: a step that leaves the state
unchanged; a step on half of the batch, the mean over the rest; an
optimizer that leaves the LayerNorm parameters, a minority of the leaves,
as they were. (One chip:
no exchange between chips to leave out.)"""
import pytest
import torch

from portbench import harness
from portbench.tests.tiny import tiny_cell

SEED = 2**31 + 5


def run(name):
    cell = tiny_cell(name)
    seconds = 3.0 if name.endswith("book_dense") else 1.0
    r = harness.run(name, SEED, seconds, False, device="cpu", cell=cell)
    r.pop("_lines")
    return r


@pytest.mark.parametrize("name", ["xl.book_dense", "xl.train3"])
def test_sound_run_is_correct(name):
    r = run(name)
    assert r["correct"], r["checks"]


def test_altered_token(monkeypatch):
    from findtextcenternet_tpu_torch.models import transformer
    orig = transformer.mask_predict_fns

    def broken(*a, **k):
        codes, p = orig(*a, **k)
        codes = codes.clone()
        codes[0, 5] = codes[0, 5] + 7
        return codes, p
    monkeypatch.setattr(transformer, "mask_predict_fns", broken)
    r = run("xl.book_dense")
    assert not r["correct"]
    assert r["checks"]["decode_gap"]["value"] > \
        r["checks"]["decode_gap"]["limit"]


def test_altered_peak(monkeypatch):
    from findtextcenternet_tpu_torch.infer import pipeline
    orig = pipeline.extract_peaks

    def broken(*a, **k):
        out = dict(orig(*a, **k))
        out["score"] = out["score"].clone()
        out["score"][0, 0] += 0.01
        return out
    monkeypatch.setattr(pipeline, "extract_peaks", broken)
    r = run("xl.book_dense")
    assert not r["correct"]
    assert r["checks"]["peaks_mismatch"]["value"] > 0


def test_shifted_heatmap(monkeypatch):
    from findtextcenternet_tpu_torch.models import detector
    orig = detector.CenterNetDetection.forward

    def broken(self, images):
        heat, feat = orig(self, images)
        return heat + 0.5 * heat.float().std().to(heat.dtype), feat
    monkeypatch.setattr(detector.CenterNetDetection, "forward", broken)
    r = run("xl.book_dense")
    assert not r["correct"]
    assert r["checks"]["heatmap_err"]["value"] > \
        r["checks"]["heatmap_err"]["limit"]


def test_step_leaves_state_unchanged(monkeypatch):
    from findtextcenternet_tpu_torch.train import state
    monkeypatch.setattr(state.ScheduleFreeRAdam, "step",
                        lambda self, grads: None)
    r = run("xl.train3")
    assert not r["correct"]
    # every leaf that moves in the reference reads about 1
    assert r["checks"]["change_gap_median"]["value"] > 0.5


def test_step_on_half_the_batch(monkeypatch):
    from findtextcenternet_tpu_torch.train import steps
    orig = steps.loss_and_grads

    def broken(state, batch):
        half = {k: v[:len(v) // 2] for k, v in batch.items()}
        return orig(state, half)
    monkeypatch.setattr(steps, "loss_and_grads", broken)
    r = run("xl.train3")
    assert not r["correct"]
    assert r["checks"]["grad_gap"]["value"] > \
        r["checks"]["grad_gap"]["limit"]


def test_norms_not_stepped(monkeypatch):
    """A minority of leaves left unstepped: the count of leaves off
    catches it directly, whatever it does to the other leaves' later
    steps."""
    from portbench import calibrate
    from portbench.drivers import train_steps
    orig = train_steps.Training.step

    def broken(self, i, half=False):
        with calibrate.norms_not_stepped(self.state.optimizer):
            return orig(self, i, half)
    monkeypatch.setattr(train_steps.Training, "step", broken)
    r = run("xl.train3")
    assert not r["correct"]
    checks = r["checks"]
    assert checks["leaves_off"]["value"] > checks["leaves_off"]["limit"]


def test_unfinished_sample_is_not_correct(monkeypatch):
    """A sampled page whose answer never comes fails the run."""
    from portbench.drivers import serve_pages
    orig = serve_pages.Serving.make_pages

    def far(self, seed):
        orig(self, seed)
        self.sample = [10**6]
    monkeypatch.setattr(serve_pages.Serving, "make_pages", far)
    r = run("xl.book_dense")
    assert not r["correct"]
    assert torch.isinf(torch.tensor(r["checks"]["decode_gap"]["value"]))
