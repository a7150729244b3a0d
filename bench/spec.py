"""A cell's files, found by the names in `BENCHMARK.json`, and the model
shape the yardstick reads from a configuration file.

A configuration file holds the published `config.json` keys as run, plus
`name`, `family`, `source`, `reduced`, `published` (the source's value of
each reduced key), `assumed` and `deployment`.  A traffic file holds the
mix's length distributions and buckets; a cell file holds what belongs to
one pairing of the two: the batch, the job's size, the traced span and
the correctness check's sample and limit.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


@dataclasses.dataclass(frozen=True)
class Spec:
    """The shapes the yardstick and the reference read from a configuration."""
    name: str
    family: str            # dense | moe
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    window: int            # 0: full causal attention
    rope_theta: float
    rms_eps: float
    dtype: str             # the served type of weights and activations
    n_experts: int = 0
    top_k: int = 0

    @property
    def moe(self) -> bool:
        return self.family == "moe"


def spec_of(conf: dict) -> Spec:
    """The Spec of a configuration file's contents."""
    heads = conf["num_attention_heads"]
    return Spec(
        name=conf["name"], family=conf["family"],
        n_layers=conf["num_hidden_layers"], d_model=conf["hidden_size"],
        n_heads=heads, n_kv_heads=conf["num_key_value_heads"],
        head_dim=conf.get("head_dim") or conf["hidden_size"] // heads,
        d_ff=conf["intermediate_size"], vocab_size=conf["vocab_size"],
        window=conf.get("sliding_window") or 0, rope_theta=float(conf["rope_theta"]),
        rms_eps=float(conf["rms_norm_eps"]), dtype=conf["torch_dtype"],
        n_experts=conf.get("num_local_experts", 0), top_k=conf.get("num_experts_per_tok", 0))


@dataclasses.dataclass(frozen=True)
class Cell:
    """One entry of `workloads`, with its configuration, traffic and cell files."""
    name: str
    chips: int
    config: dict
    traffic: dict
    cell: dict

    @property
    def spec(self) -> Spec:
        return spec_of(self.config)


def _read(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return _read(root / "BENCHMARK.json")


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of `BENCHMARK.json`, its files found by name:
    the configuration's `file`, `bench/traffic/<traffic>.json` and
    `bench/cells/<name>.json`."""
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    return Cell(name=name, chips=w["chips"],
                config=_read(root / configs[w["config"]]["file"]),
                traffic=_read(root / "bench" / "traffic" / f"{w['traffic']}.json"),
                cell=_read(root / "bench" / "cells" / f"{name}.json"))


def metric_entries(name: str, trace: bool, root: Path = ROOT) -> list[dict]:
    """The metrics a run of cell `name` reports: the end-to-end ones
    untraced, the per-layer ones traced, each kept where its `workloads`
    (if any) lists the cell."""
    bench = benchmark(root)
    entries = bench["per_layer" if trace else "end_to_end"]
    return [m for m in entries if name in m.get("workloads", [name])]
