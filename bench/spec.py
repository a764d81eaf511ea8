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

A configuration file's ``model`` states the model once, for both sides: the
plain reference reads the whole dict, and :func:`program_config` makes the
program's ``ModelConfig`` from it.  Every key of ``model`` is a field of
the program's ``ModelConfig`` (under ``moe`` / ``ssm``: of ``MoEConfig`` /
``SSMConfig``), or is listed in the file's ``program_only``: the keys the
program's configuration classes have no field for, nested ones dotted
(``"moe.norm_topk_prob"``, ``"rope_scaling"``).  A file that lists any
names a ``program_builder``, ``"<module>:<function>"`` with the module the
program's own (``repro_torch`` or under it), which is called as
``function(name, model)`` with a deep copy of ``model`` and returns an
instance of the program's ``ModelConfig`` (a subclass is fine) that carries
the listed settings as the program chooses.  The builder adds only those:
every field of the program's ``ModelConfig``, ``MoEConfig`` and
``SSMConfig`` on its result has to equal what ``ModelConfig`` made from
the other keys holds, or the run stops, naming the field.  A file without
either key is built as ``ModelConfig(name=name, **model)``.
"""

from __future__ import annotations

import copy
import dataclasses
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


PROGRAM = "repro_torch"      # the only package a program builder may come from


def _classes():
    """The program's configuration classes: ``ModelConfig`` and the class
    of each nested group."""
    from repro_torch.models.config import MoEConfig, ModelConfig, SSMConfig
    return ModelConfig, {"moe": MoEConfig, "ssm": SSMConfig}


def _fields(cls) -> list[str]:
    return [f.name for f in dataclasses.fields(cls)]


def _unknown_keys(model: dict) -> list[str]:
    """Keys of ``model`` that the program's configuration classes have no
    field for, nested ones dotted."""
    top, nested = _classes()
    out = []
    for key, value in model.items():
        if key in nested and isinstance(value, dict):
            fields = _fields(nested[key])
            out += [f"{key}.{k}" for k in value if k not in fields]
        elif key == "name" or key not in _fields(top):
            out.append(key)
    return out


def _builder(ref: str):
    """The function a ``program_builder`` names, from the program only."""
    module, sep, fn = ref.partition(":")
    if not sep or not fn or module.split(".")[0] != PROGRAM:
        raise ValueError(f"program_builder {ref!r}: not '<module>:<function>' "
                         f"with a module of {PROGRAM}")
    return getattr(importlib.import_module(module), fn)


def _differing_field(got, want, nested: dict) -> str | None:
    """The first field of the program's classes in which ``got`` differs
    from ``want``, dotted where nested; ``None`` where none does."""
    for name in _fields(type(want)):
        a, b = getattr(got, name), getattr(want, name)
        if name in nested and a is not None and b is not None:
            for sub in _fields(nested[name]):
                if getattr(a, sub, None) != getattr(b, sub):
                    return f"{name}.{sub}"
        elif a != b:
            return name
    return None


def program_config(config: dict):
    """The program's ``ModelConfig`` for a configuration file's ``model``,
    by the contract of this module's docstring."""
    top, nested = _classes()
    name, model = config["name"], config["model"]
    listed = list(config.get("program_only", []))
    builder = config.get("program_builder")
    unknown = _unknown_keys(model)
    if unlisted := [k for k in unknown if k not in listed]:
        raise ValueError(f"{name}: model keys that are no field of the "
                         f"program's ModelConfig and not in program_only: "
                         f"{unlisted}")
    if stray := [k for k in listed if k not in unknown]:
        raise ValueError(f"{name}: program_only lists keys that the model "
                         f"does not state or that are fields: {stray}")
    if listed and builder is None:
        raise ValueError(f"{name}: program_only {listed} needs a "
                         f"program_builder")
    m = {k: v for k, v in model.items() if k not in listed}
    for key, cls in nested.items():
        if m.get(key) is not None:
            m[key] = cls(**{k: v for k, v in m[key].items()
                            if f"{key}.{k}" not in listed})
    for key in ("block_pattern", "window_pattern"):
        if key in m:
            m[key] = tuple(m[key])
    plain = top(name=name, **m)
    if builder is None:
        return plain
    cfg = _builder(builder)(name, copy.deepcopy(model))
    if not isinstance(cfg, top):
        raise TypeError(f"{name}: program_builder {builder} returned a "
                        f"{type(cfg).__name__}, not the program's ModelConfig")
    if (field := _differing_field(cfg, plain, nested)) is not None:
        raise ValueError(f"{name}: program_builder {builder} changed {field}"
                         f" from what the file states")
    return cfg
