"""Tiny CPU versions of the cells: the published widths, small images."""
import copy
import time

import torch

from bench_port import core, run

MATCH = dict(batch=2, pairs=4, views=[[48, 80, 80, 48]], pad=[80, 80],
             warmup_batches=2, check_batches=1)
TRAIN = dict(batch=2, pairs=8, views=[[184, 240, 240, 184]], pad=[240, 240],
             log_every=2)


def tiny_cell(name: str, dtype: str = None) -> core.Cell:
    cell = copy.deepcopy(core.load_cell(name))
    cell.mix.update(TRAIN if cell.mix["generator"] == "train" else MATCH)
    if dtype:
        cell.config["dtype"] = dtype
    return cell


def run_cpu(cell, seed: int = 2 ** 31 + 5, seconds: float = 5.0):
    """The rest of a run on the CPU: set-up, window and check (the look
    for a card is what the tests skip).  Few threads a test worker, so
    that parallel workers do not slow each other's window to nothing."""
    torch.set_num_threads(2)
    return run.measure(cell, seed, seconds, False, torch.device("cpu"),
                       time.perf_counter())
