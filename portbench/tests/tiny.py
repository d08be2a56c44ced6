"""The cells of BENCHMARK.json cut to a size the CPU runs in seconds, for the
tests: the tiny detector on 128x128 tiles, a 64-d
Transformer of 2+2 blocks at 64 tokens, small pages and batches. Only the
sizes change; the drivers, the wrappers, the reference and the judge are
the cell's own."""
from __future__ import annotations

import copy

from portbench import harness
from portbench.reference import detector as ref_det

TRANSFORMER = {"embed_dim": 64, "head_num": 4, "enc_block_num": 2,
               "dec_block_num": 2, "max_enc_seq_len": 64,
               "max_dec_seq_len": 64}
PAGE = {"page_w": 320, "page_h": 224, "char": 16, "margin_top": 12,
        "margin_left": 12, "pool_pages": 2, "sample_within": 2,
        "reference_tiles": 2}
TRAIN = {"batches": 4, "max_len": 60, "split_min": 4, "split_max": 12,
         "warm_steps": 1}


def tiny_cell(name: str, trace: bool = False) -> harness.Cell:
    cell = harness.find_cell(name, trace)
    cfg = copy.deepcopy(cell.config)
    cfg["detector"].update(model_size="tiny",
                           stages=[list(s) for s in ref_det.STAGES["tiny"]])
    cfg["transformer"].update(TRANSFORMER)
    cfg["inference"].update(tile_size=128, detector_batch=4,
                            max_peaks_per_tile=256)
    cfg["train"].update(batch_size=4)
    traffic = dict(cell.traffic)
    traffic.update(PAGE if traffic["driver"] == "serve_pages" else TRAIN)
    limits = copy.deepcopy(cell.limits)
    return harness.Cell(cell.name, cell.entry, cfg, traffic, limits,
                        cell.metrics)
