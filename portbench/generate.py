"""The traffic generators: book pages for the serving cells, Transformer
batches for the training cells. Each reads the parameters of a traffic file
(``portbench/traffic/<mix>.json``) and a seed; a seed changes the content
and the order, never the amount of work: every seed gets the same counts
and lengths.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from . import weights

SOT, EOT, MSK = 1, 2, 3
SP = 5.0          # the encoder's start/end marker value


def book_page(rng: np.random.Generator, p: Dict):
    """A text-like page and the raw detection candidates it would give:
    lines of square glyph blots at a book scan's density (a numpy copy of
    the JAX package's benchmark page, as ``chip_smoke.py`` draws it), with
    exactly ``fill`` of the glyph slots inked and ``duplicate`` of those
    given an overlapping weaker candidate.

    Returns ``(image (H,W,3) uint8, candidates (N,9) f32 [score, cx, cy, w,
    h, code1..4], lines (H/4,W/4) f32, seps (H/4,W/4) f32)``."""
    h, w, ch = p["page_h"], p["page_w"], p["char"]
    mt, ml = p["margin_top"], p["margin_left"]
    img = np.full((h, w, 3), p["paper"], np.uint8)
    lines = np.zeros((h // 4, w // 4), np.float32)
    seps = np.zeros_like(lines)
    slots = []
    y = mt
    while y + ch < h - mt:
        x = ml
        while x + ch < w - ml:
            slots.append((x, y))
            x += int(ch * p["advance"])
        lines[y // 4:(y + ch) // 4, 20:(w - ml) // 4] = 1.0
        y += int(ch * p["line_gap"])
    n_fill = int(round(p["fill"] * len(slots)))
    filled = np.sort(rng.permutation(len(slots))[:n_fill])
    n_dup = int(round(p["duplicate"] * n_fill))
    dups = set(rng.permutation(n_fill)[:n_dup].tolist())
    locs = []
    for j, si in enumerate(filled):
        x, y = slots[si]
        img[y:y + ch - 6, x:x + ch - 6] = rng.integers(0, p["ink_max"])
        size = ch * 0.9
        locs.append([rng.uniform(0.6, 1.0), x + ch / 2, y + ch / 2, size,
                     size, 0, 0, 0, 0])
        if j in dups:
            locs.append([rng.uniform(0.4, 0.6),
                         x + ch / 2 + rng.uniform(-2, 2),
                         y + ch / 2 + rng.uniform(-2, 2), size, size,
                         0, 0, 0, 0])
    return img, np.asarray(locs, np.float32), lines, seps


def page_features(n: int, dim: int, seed: int, index: int, device):
    """(n, dim) f16 glyph features on ``device``, standard normal."""
    g = weights.generator(seed, device, "features", index)
    return torch.randn((n, dim), generator=g, device=device
                       ).to(torch.float16)


def line_length(ask: int, split: int) -> int:
    """The characters upstream's synthetic line text holds when it is asked
    for ``ask`` characters in lines of ``split`` (each line ``split`` codes
    and a newline; whole lines only, at least one): the loop of
    ``random_text``, upstream ``dataset/data_transformer.py:636-658``."""
    per = split + 1
    return per * max(1, -(-ask // per) - 1)


def train_lengths(p: Dict, batch: int) -> List[int]:
    """The encoder content lengths of a batch's rows by upstream's rule
    (``random_text``; the port's ``data/transformer_data.py:282-302``): a
    row asks for ``max_len`` characters with probability ``p_full``, else
    for a uniform 1..``max_len``-1, and is cut into lines of a uniform
    ``split_min``..``split_max`` codes. Drawn as exact shares, not by
    chance: ``round(p_full * batch)`` full rows, the others' asks and every
    row's split evenly spaced, paired by a fixed permutation. The same set
    in every batch of every seed."""
    n_full = int(round(p["p_full"] * batch))
    asks = [p["max_len"]] * n_full + np.linspace(
        1, p["max_len"] - 1, batch - n_full).round().astype(int).tolist()
    splits = np.linspace(p["split_min"], p["split_max"], batch
                         ).round().astype(int)
    splits = splits[np.random.default_rng(0).permutation(batch)]
    return [line_length(a, int(s)) for a, s in zip(asks, splits)]


def train_batches(p: Dict, dims: Dict, batch: int, seed: int, device
                  ) -> List[Dict[str, torch.Tensor]]:
    """``p["batches"]`` distinct batches of ``batch`` rows on ``device``:
    encoder rows ``[+SP marker, content, -SP marker, zeros]`` with standard
    normal features and 0/5 flags, decoder targets ``[SOT, codes, EOT,
    PAD]`` of as many codes as content rows (codes from ``charset``
    ranges), decoder inputs masked at a per-row rate from an even spread
    over ``[mask_min, mask_max]``. Lengths and rates are permuted over the
    rows by the seed."""
    enc_len, dec_len = dims["max_enc_seq_len"], dims["max_dec_seq_len"]
    enc_dim = dims["enc_input_dim"]
    fdim = enc_dim - 6
    charset = torch.cat([torch.arange(a, b) for a, b in p["charset"]]
                        ).to(device)
    sp = torch.zeros(enc_dim, device=device)
    sp[0:fdim:2], sp[1:fdim:2] = SP, -SP
    lengths = torch.tensor(train_lengths(p, batch), device=device)
    rates = torch.linspace(p["mask_min"], p["mask_max"], batch,
                           device=device)
    out = []
    for bi in range(p["batches"]):
        g = weights.generator(seed, device, "train_batch", bi)
        ln = lengths[torch.randperm(batch, generator=g, device=device)]
        rt = rates[torch.randperm(batch, generator=g, device=device)]
        pos = torch.arange(enc_len, device=device)[None, :]
        content = (pos >= 1) & (pos <= ln[:, None])
        feats = torch.randn((batch, enc_len, enc_dim), generator=g,
                            device=device)
        flags = (torch.rand((batch, enc_len, 6), generator=g, device=device)
                 < p["flag_rate"]).float() * SP
        feats[..., fdim:] = flags
        enc = torch.where(content[..., None], feats, 0.0)
        enc[:, 0] = sp
        enc[torch.arange(batch, device=device), ln + 1] = -sp
        tpos = torch.arange(dec_len, device=device)[None, :]
        codes = charset[torch.randint(len(charset), (batch, dec_len),
                                      generator=g, device=device)]
        true = torch.where((tpos >= 1) & (tpos <= ln[:, None]), codes, 0)
        true[:, 0] = SOT
        true[torch.arange(batch, device=device), ln + 1] = EOT
        masked = torch.rand((batch, dec_len), generator=g,
                            device=device) < rt[:, None]
        dec_in = torch.where(masked, MSK, true)
        out.append({"encoder_input": enc, "decoder_input": dec_in.long(),
                    "decoder_true": true.long(),
                    "enc_keys": (ln + 2).tolist()})
    return out
