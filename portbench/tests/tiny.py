"""A cell at a size the CPU tests can hold: the real cell's files, with
the model cut to a few widths and float32, and the traffic to short
samples; the limits are the real cell's."""
from __future__ import annotations

import dataclasses
import json
import time

import torch

from portbench import bench

CPU = torch.device("cpu")
SEED = 2 ** 33 + 5


def tiny_model(model: dict) -> dict:
    return {**model, "n_layers": 2, "d_model": 64, "n_heads": 4,
            "n_kv_heads": 4, "d_head": 16, "d_ff": 128, "vocab": 500,
            "dtype": "float32", "reference_chunk_tokens": 256}


def tiny_spec(spec: dict, encdec: bool) -> dict:
    max_len = 64 if encdec else 128
    spec = {**spec, "pool": 3,
            "stream": {**spec["stream"], "n_tasks": 8, "global_tokens": 512,
                       "max_len": max_len}}
    if spec["mode"] == "dynamic":
        spec["palette"] = {**spec["palette"], "min_seq": 16,
                           "max_seq": max_len, "seq_align": 16}
    else:
        spec["row_len"] = [64, 16] if encdec else 128
        spec["rows_per_micro_batch"] = 2
    return spec


def tiny_cell(name: str) -> bench.Cell:
    cell = bench.load_cell(name)
    encdec = cell.model["family"] == "encdec"
    return dataclasses.replace(cell, model=tiny_model(cell.model),
                               spec=tiny_spec(cell.spec, encdec))


def cells() -> list:
    return [w["name"] for w in json.loads(
        (bench.ROOT / "BENCHMARK.json").read_text())["workloads"]]


def run(cell, mode=None, trace=False, seed=SEED):
    return bench.run_cell(cell, seed, 0.2, trace, CPU, time.perf_counter(),
                          mode=mode)
