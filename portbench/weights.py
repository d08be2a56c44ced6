"""Seeded inputs and random weights, drawn on the device in a few large
calls; the same tensors go to the program and to the reference."""
from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import numpy as np
import torch


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed from ``seed`` and string or int tags (every bit of the
    result depends on all of them)."""
    words = [int(seed) & 0xFFFFFFFF, int(seed) >> 32]
    for t in tags:
        if isinstance(t, str):
            words += list(t.encode())
        else:
            words += [int(t) & 0xFFFFFFFF, int(t) >> 32]
    return int(np.random.SeedSequence(words).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, device, *tags) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, *tags))
    return g


def draw(specs: Iterable[Tuple[str, tuple, object]], gen: torch.Generator,
         device, tables=None) -> Dict[str, torch.Tensor]:
    """A state dict of f32 tensors on ``device`` from ``(key, shape, kind)``
    specs: every normal drawn in one call and split, each scaled to its
    kind's standard deviation (``conv`` / ``dense``: 1/sqrt(fan-in);
    ``embed``: 1/sqrt(width)); ``one`` / ``zero`` / ``bias`` / ``count``
    constants; ``("sin", n)`` the sinusoid table ``tables(n, width)``."""
    specs = list(specs)
    normal = [(k, s, kind) for k, s, kind in specs
              if kind in ("conv", "dense", "embed")]
    total = sum(math.prod(s) for _, s, _ in normal)
    flat = torch.randn(total, generator=gen, device=device)
    out, i = {}, 0
    for k, s, kind in normal:
        n = math.prod(s)
        fan = s[-1] if kind == "embed" else math.prod(s[1:])
        out[k] = flat[i:i + n].view(s).mul_(1.0 / math.sqrt(fan))
        i += n
    for k, s, kind in specs:
        if k in out:
            continue
        if kind == "one":
            out[k] = torch.ones(s, device=device)
        elif kind in ("zero", "bias"):
            out[k] = torch.zeros(s, device=device)
        elif kind == "count":
            out[k] = torch.zeros((), dtype=torch.long, device=device)
        elif isinstance(kind, tuple) and kind[0] == "sin":
            out[k] = torch.from_numpy(tables(kind[1], s[1])).to(device)
        else:
            raise ValueError(f"unknown kind {kind!r} of {k}")
    return {k: out[k] for k, _, _ in specs}
