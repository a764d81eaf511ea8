"""Everything one cell's run needs, found by name from ``BENCHMARK.json``.

* the configuration: the ``file`` its entry names (sizes, the program's
  model settings, its plain reference's module under ``plainref/``);
* the traffic mix: ``traffic/<traffic>.json`` (the generator module under
  ``generators/`` it names, and that generator's parameters);
* the cell: ``cells/<workload>.json`` (its offered rate, replica speeds and
  the limits of its correctness check);
* its metrics: the ``end_to_end`` (with ``--trace 0``) or ``per_layer``
  (``--trace 1``) entries that list this workload or list none, each
  computed by ``metrics/<name>.py``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


@dataclass
class CellSpec:
    name: str
    config: dict
    traffic: dict
    cell: dict
    metrics: list        # BENCHMARK.json metric entries this run reports
    chips: int = 1

    @property
    def model(self) -> dict:
        return self.config["model"]

    def reference(self):
        """The configuration's plain reference module."""
        return importlib.import_module(f"bench.plainref.{self.config['reference']}")

    def generator(self):
        return importlib.import_module(
            f"bench.generators.{self.traffic['generator']}")


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(workload: str, trace: bool, root: Path = ROOT) -> CellSpec:
    """The cell ``workload`` of ``root/BENCHMARK.json``."""
    bench = _load(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    kind = "per_layer" if trace else "end_to_end"
    metrics = [m for m in bench[kind]
               if workload in m.get("workloads", [workload])]
    return CellSpec(name=workload, config=_load(root / conf["file"]),
                    traffic=_load(BENCH / "traffic" / f"{w['traffic']}.json"),
                    cell=_load(BENCH / "cells" / f"{workload}.json"),
                    metrics=metrics, chips=w["chips"])


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read`` function."""
    path = BENCH / "metrics" / f"{name}.py"
    mod_name = "bench.metrics." + name.replace(".", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def program_config(config: dict):
    """The program's ``ModelConfig`` for a configuration file's ``model``."""
    from repro_torch.models.config import MoEConfig, ModelConfig, SSMConfig
    m = dict(config["model"])
    for key, cls in (("ssm", SSMConfig), ("moe", MoEConfig)):
        if m.get(key) is not None:
            m[key] = cls(**m[key])
    for key in ("block_pattern", "window_pattern"):
        if key in m:
            m[key] = tuple(m[key])
    return ModelConfig(name=config["name"], **m)
