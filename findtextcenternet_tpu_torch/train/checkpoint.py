"""Checkpoint save/restore with ``torch.save``.

The port's counterpart of ``findtextcenternet_tpu/train/checkpoint.py``
(orbax there), with the same contract: a directory ``step_%09d`` per save
under ``ckpt_dir`` holding the whole training state (step, parameters and
BatchNorm buffers, optimizer state, the CoV statistics of the detector)
and the averaged eval weights (with the buffers), the config JSON beside,
the newest ``keep`` saves kept. Restoring continues training exactly. The
files hold CPU tensors, so a checkpoint written on the card loads on the
CPU and back.

Under a mesh every rank calls :func:`save_checkpoint`: the ZeRO-1 slices
of the optimizer state and the tensor-parallel slices of the weights are
gathered (collectives), so the file holds the whole, layout-free state,
which rank 0 writes. It restores onto any mesh, or onto one process: each
rank keeps its slices of what it loads.
"""
from __future__ import annotations

import os
import shutil
from typing import Dict, Optional

import torch

from ..config import Config, to_json
from ..losses import CoVState
from ..parallel import collectives as coll
from ..parallel.mesh import gather_tp, slice_tp
from .state import TrainState

STATE_FILE = "state.pt"


def _cpu(tree):
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return tree


def _whole_state(state: TrainState) -> dict:
    """The layout-free training state (a collective under a mesh)."""
    model = state.model
    opt = state.optimizer.state_dict()
    for b in state.optimizer.BUFFERS:
        opt[b] = gather_tp(opt[b], model)
    return {
        "step": state.step,
        "params": _cpu(gather_tp(
            {k: v.detach() for k, v in model.state_dict().items()}, model)),
        "eval_params": _cpu(state.eval_state_dict()),
        "opt_state": _cpu(opt),
        "cov": _cpu(state.cov.state_dict()) if state.cov is not None else {},
    }


def save_checkpoint(ckpt_dir: str, state: TrainState,
                    config: Optional[Config] = None, keep: int = 3) -> str:
    ckpt_dir = os.path.abspath(ckpt_dir)
    path = os.path.join(ckpt_dir, f"step_{state.step:09d}")
    payload = _whole_state(state)
    if coll.world_rank() == 0:
        _write(ckpt_dir, path, payload, config, keep)
    coll.barrier()
    return path


def _write(ckpt_dir: str, path: str, payload: dict,
           config: Optional[Config], keep: int) -> None:
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    if config is not None:
        with open(os.path.join(ckpt_dir, "config.json"), "w") as f:
            f.write(to_json(config))
    _prune(ckpt_dir, keep)


def _steps(ckpt_dir: str):
    return sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))


def _prune(ckpt_dir: str, keep: int):
    for d in _steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _steps(ckpt_dir)
    return os.path.join(ckpt_dir, steps[-1]) if steps else None


def _load(path: str) -> dict:
    return torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                      weights_only=True)


def restore_checkpoint(path: str, state: TrainState) -> TrainState:
    """Load a checkpoint into an initialised ``state`` (in place; the
    tensors move to the model's device; under a mesh each rank keeps its
    slices)."""
    payload = _load(path)
    model = state.model
    model.load_state_dict({k: slice_tp(k, v, model)
                           for k, v in payload["params"].items()})
    opt = dict(payload["opt_state"])
    for b in state.optimizer.BUFFERS:
        opt[b] = {k: slice_tp(k, v, model) for k, v in opt[b].items()}
    state.optimizer.load_state_dict(opt)
    if state.cov is not None:
        state.cov = CoVState(**payload["cov"]).to(state.cov.t.device)
    state.step = int(payload["step"])
    return state


def load_eval_params(path: str) -> Dict[str, torch.Tensor]:
    """Inference-ready weights of a checkpoint: the model's state dict with
    the schedule-free eval (averaged) weights and, for the detector, its
    BN running statistics."""
    return _load(path)["eval_params"]
