"""The flag parser that the three training CLIs share.

Each CLI takes its JAX counterpart's ``--flag=value`` arguments plus two of
the port's own:

- ``--device X`` (or ``--device=X``): where the run goes (the default is
  the card);
- ``--config=cfg.json``: a whole port config (``config.to_json``) to start
  from, in place of the CLI's defaults; the other flags then override it.
  The JAX CLIs can only change the few fields their flags name, so a run
  at another size (a tiny model on the CPU, say) needs this one.

Started by ``torchrun --nproc-per-node=N -m ...`` (or with JAX's
``JAX_COORDINATOR`` / ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``), a CLI
joins the process group that environment describes (:func:`join_ranks`)
and trains on the mesh ``TrainConfig.data_axis`` / ``model_axis`` give.
"""
from __future__ import annotations

import dataclasses
import glob

from ..config import Config, config_from_json

# flag -> (config section, field, parse), for every training CLI
CONFIG_FLAGS = {
    "--batch-size": ("train", "batch_size", int),
    "--epochs": ("train", "epochs", int),
    "--lr": ("train", "learning_rate", float),
    "--checkpoint-dir": ("train", "checkpoint_dir", str),
}
# the detector CLIs' (train1, train2) further config flag
MODEL_SIZE_FLAG = {"--model-size": ("detector", "model_size", str)}


def glob_sorted(pattern: str):
    return sorted(glob.glob(pattern))


def parse_flags(argv, cfg: Config, kw: dict, extra=(),
                config_flags=()) -> Config:
    """Apply ``argv`` to ``cfg`` (returned) and ``kw`` (updated).

    ``config_flags`` adds ``flag -> (section, field, parse)`` entries to
    ``CONFIG_FLAGS``; ``extra`` maps further flags to a ``(kw key, parse)``
    pair, where a parse of None makes the flag a switch (True). An unknown
    argument exits."""
    dc = dataclasses
    args = list(argv)
    for a in args:
        if a.startswith("--config="):
            with open(a.split("=", 1)[1], encoding="utf-8") as f:
                cfg = config_from_json(f.read())
    flags = dict(CONFIG_FLAGS, **dict(config_flags))
    extra = dict(extra, **{"--device": ("device", str)})
    it = iter(args)
    for a in it:
        if a == "--device":
            a = "--device=" + next(it)
        name, _, value = a.partition("=")
        if name in flags:
            section, field, parse = flags[name]
            cfg = dc.replace(cfg, **{section: dc.replace(
                getattr(cfg, section), **{field: parse(value)})})
        elif name in extra:
            key, parse = extra[name]
            kw[key] = parse(value) if parse else True
        elif name != "--config":
            raise SystemExit(f"unknown argument {a!r}")
    return cfg


def join_ranks(kw: dict) -> bool:
    """Initialise the process group the environment describes (NCCL on the
    card, gloo with ``--device cpu``) and build the kernels and native
    libraries once a host before the ranks use them; False, and nothing
    done, for a single process."""
    from ..parallel.distributed import build_once, init_distributed
    if not init_distributed(device=kw.get("device")):
        return False
    build_once(kw.get("device"))
    return True
