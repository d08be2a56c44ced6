"""Checkpoint save/restore with ``torch.save``.

The port's counterpart of ``findtextcenternet_tpu/train/checkpoint.py``
(orbax there), with the same contract: a directory ``step_%09d`` per save
under ``ckpt_dir`` holding the whole training state (step, parameters,
optimizer state) and the averaged eval weights, the config JSON beside,
the newest ``keep`` saves kept. Restoring continues training exactly. The
files hold CPU tensors, so a checkpoint written on the card loads on the
CPU and back.
"""
from __future__ import annotations

import os
import shutil
from typing import Dict, Optional

import torch

from ..config import Config, to_json
from .state import TrainState

STATE_FILE = "state.pt"


def _cpu(tree):
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return tree


def save_checkpoint(ckpt_dir: str, state: TrainState,
                    config: Optional[Config] = None, keep: int = 3) -> str:
    ckpt_dir = os.path.abspath(ckpt_dir)
    path = os.path.join(ckpt_dir, f"step_{state.step:09d}")
    os.makedirs(path, exist_ok=True)
    payload = {
        "step": state.step,
        "params": _cpu(state.model.state_dict()),
        "eval_params": _cpu(state.eval_state_dict()),
        "opt_state": _cpu(state.optimizer.state_dict()),
    }
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    if config is not None:
        with open(os.path.join(ckpt_dir, "config.json"), "w") as f:
            f.write(to_json(config))
    _prune(ckpt_dir, keep)
    return path


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
    tensors move to the model's device)."""
    payload = _load(path)
    state.model.load_state_dict(payload["params"])
    state.optimizer.load_state_dict(payload["opt_state"])
    state.step = int(payload["step"])
    return state


def load_variables(path: str) -> Dict[str, torch.Tensor]:
    """Inference-ready weights of a checkpoint: the Transformer state dict
    with the schedule-free eval (averaged) weights."""
    return _load(path)["eval_params"]
