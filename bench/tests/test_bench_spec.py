"""The configuration file's contract with the program (``bench/spec.py``
``program_config``): a file of the program's fields alone builds the
program's ``ModelConfig`` as before; keys it has no field for are listed in
``program_only`` and carried by a ``program_builder`` of the program's own,
which may add them and change nothing the file states.  Stand-in builders
are registered under the program's package in ``sys.modules`` for the
test alone."""

import copy
import dataclasses
import json
import sys
import time
import types
from pathlib import Path

import pytest
import torch

from bench import harness, result
from bench.spec import program_config
from bench.tests.smoke import MLA_MOE, cell, references
from repro_torch.models.config import MoEConfig, ModelConfig, SSMConfig

BENCH = Path(__file__).resolve().parents[1]
STANDIN = "repro_torch._bench_standin"


AS_BEFORE = {
    "deepseek-7b": ModelConfig(
        name="deepseek-7b", num_layers=30, d_model=4096, num_heads=32,
        num_kv_heads=32, d_ff=11008, vocab_size=102400, norm_eps=1e-6,
        rope_theta=10000.0, param_dtype="bfloat16",
        compute_dtype="bfloat16"),
    "falcon-mamba-7b": ModelConfig(
        name="falcon-mamba-7b", num_layers=64, d_model=4096, num_heads=1,
        num_kv_heads=1, d_ff=0, vocab_size=65024, block_pattern=("mamba",),
        norm_eps=1e-5, ssm=SSMConfig(d_inner=8192, d_state=16, d_conv=4,
                                     dt_rank=256, chunk=16, bcdt_rms=True),
        param_dtype="bfloat16", compute_dtype="bfloat16"),
}


def _file(name: str) -> dict:
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def _standin(monkeypatch, build) -> str:
    """Register ``build`` as a builder of the program's package."""
    mod = types.ModuleType(STANDIN)
    mod.build = build
    monkeypatch.setitem(sys.modules, STANDIN, mod)
    return f"{STANDIN}:build"


def _plain(name: str, model: dict) -> ModelConfig:
    """``ModelConfig`` of a model dict, its nested groups as classes."""
    m = dict(model)
    if m.get("moe") is not None:
        m["moe"] = MoEConfig(**m["moe"])
    return ModelConfig(name=name, **m)


@pytest.mark.parametrize("name", sorted(AS_BEFORE))
def test_existing_files_build_as_before(name):
    got = program_config(_file(name))
    assert type(got) is ModelConfig
    assert got == AS_BEFORE[name]
    assert dataclasses.asdict(got) == dataclasses.asdict(AS_BEFORE[name])


@pytest.mark.parametrize("key, model", [
    ("rope_scaling", dict(MLA_MOE, rope_scaling={"type": "yarn",
                                                 "factor": 40})),
    ("moe.norm_topk_prob", dict(MLA_MOE, moe=dict(MLA_MOE["moe"],
                                                  norm_topk_prob=False))),
])
def test_unlisted_unknown_key_is_refused_by_name(key, model):
    with pytest.raises(ValueError, match=key.replace(".", r"\.")):
        program_config({"name": "m", "model": model})
    # listed, but another one left out: that one is named
    with pytest.raises(ValueError, match="routed_scaling_factor"):
        program_config({"name": "m", "program_only": [key],
                        "program_builder": "repro_torch.x:build",
                        "model": dict(model, routed_scaling_factor=16.0)})


def test_program_only_needs_a_builder():
    model = dict(MLA_MOE, rope_scaling={"type": "yarn"})
    with pytest.raises(ValueError, match="program_builder"):
        program_config({"name": "m", "model": model,
                        "program_only": ["rope_scaling"]})


def test_program_only_lists_only_keys_without_a_field():
    with pytest.raises(ValueError, match="num_layers"):
        program_config({"name": "m", "model": MLA_MOE,
                        "program_only": ["num_layers"],
                        "program_builder": "repro_torch.x:build"})


@pytest.mark.parametrize("ref", [
    "repro.models.config:ModelConfig", "benchmarks.port.x:build",
    "bench.spec:program_config", "repro_torchx.configs:build",
    "repro_torch.models.config", "repro_torch.models.config:",
])
def test_builder_outside_the_program_is_refused(ref):
    before = {m for m in sys.modules if m.split(".")[0] in
              ("repro", "benchmarks", "repro_torchx")}
    model = dict(MLA_MOE, rope_scaling={"type": "yarn"})
    with pytest.raises(ValueError, match="program_builder"):
        program_config({"name": "m", "model": model,
                        "program_only": ["rope_scaling"],
                        "program_builder": ref})
    after = {m for m in sys.modules if m.split(".")[0] in
             ("repro", "benchmarks", "repro_torchx")}
    assert after == before


@pytest.mark.parametrize("field, change", [
    ("num_layers", lambda c: dataclasses.replace(c, num_layers=6)),
    ("moe.top_k", lambda c: dataclasses.replace(
        c, moe=dataclasses.replace(c.moe, top_k=3))),
    ("kv_lora_rank", lambda c: dataclasses.replace(c, kv_lora_rank=64)),
    ("qk_norm", lambda c: dataclasses.replace(c, qk_norm=True)),
    ("name", lambda c: dataclasses.replace(c, name="other")),
])
def test_builder_that_changes_a_field_is_refused(monkeypatch, field, change):
    def build(name, model):
        model.pop("rope_scaling")
        return change(_plain(name, model))

    ref = _standin(monkeypatch, build)
    with pytest.raises(ValueError, match=f"changed {field}"):
        program_config({"name": "m", "program_builder": ref,
                        "program_only": ["rope_scaling"],
                        "model": dict(MLA_MOE, rope_scaling={"f": 40})})


def test_builder_must_return_the_programs_config(monkeypatch):
    ref = _standin(monkeypatch, lambda name, model: dict(model, name=name))
    with pytest.raises(TypeError, match="ModelConfig"):
        program_config({"name": "m", "program_builder": ref,
                        "model": MLA_MOE})


def test_builder_gets_a_deep_copy_and_may_return_a_subclass(monkeypatch):
    @dataclasses.dataclass(frozen=True)
    class WithRouting(ModelConfig):
        norm_topk_prob: bool = True

    def build(name, model):
        flag = model["moe"].pop("norm_topk_prob")
        cfg = WithRouting(**dataclasses.asdict(_plain(name, model)) | {
            "moe": MoEConfig(**model["moe"]), "norm_topk_prob": flag})
        model["moe"]["top_k"] = 99          # the file's dict stays as it is
        return cfg

    config = {"name": "m", "program_builder": _standin(monkeypatch, build),
              "program_only": ["moe.norm_topk_prob"],
              "model": dict(MLA_MOE, moe=dict(MLA_MOE["moe"],
                                               norm_topk_prob=False))}
    kept = copy.deepcopy(config)
    cfg = program_config(config)
    assert config == kept
    assert isinstance(cfg, WithRouting) and cfg.norm_topk_prob is False
    assert cfg.moe == MoEConfig(**MLA_MOE["moe"])


def test_a_cell_served_through_a_builder(monkeypatch):
    """The llama smoke cell through a stand-in builder that checks and
    drops one ``program_only`` key: what the builder returns is what the
    run's parameters and engines are made from, the run is correct, and it
    serves the tokens of the same cell without the hook."""
    from repro_torch.models import model as model_mod
    from repro_torch import serve

    torch.set_num_threads(1)
    seed = 2 ** 31 + 23
    runs = {}
    execute = harness.execute

    def recording_execute(spec, *args, **kw):
        run, weights = execute(spec, *args, **kw)
        runs[spec.config.get("program_builder")] = run
        return run, weights

    monkeypatch.setattr(harness, "execute", recording_execute)
    plain = result.measure(cell("llama"), seed, 2.0, False, "cpu",
                           time.perf_counter())

    built, seen = [], []

    def build(name, model):
        assert model.pop("standin_rope_note") == "kept out of ModelConfig"
        built.append(ModelConfig(name=name, **model))
        return built[-1]

    specs, engine = model_mod.param_specs, serve.ServeEngine

    def param_specs(cfg):
        seen.append(("param_specs", cfg))
        return specs(cfg)

    class RecordingEngine(engine):
        def __post_init__(self):
            seen.append(("ServeEngine", self.cfg))
            super().__post_init__()

    monkeypatch.setattr(model_mod, "param_specs", param_specs)
    monkeypatch.setattr(serve, "ServeEngine", RecordingEngine)
    spec = cell("llama")
    ref = _standin(monkeypatch, build)
    spec.config = dict(spec.config, program_builder=ref,
                       program_only=["standin_rope_note"],
                       model=dict(spec.config["model"],
                                  standin_rope_note="kept out of "
                                                    "ModelConfig"))
    hooked = result.measure(spec, seed, 2.0, False, "cpu",
                            time.perf_counter())

    assert len(built) == 1
    kinds = [k for k, _ in seen]
    assert "param_specs" in kinds and kinds.count("ServeEngine") == 3
    assert all(cfg is built[0] for _, cfg in seen)
    assert plain["correct"] and hooked["correct"], hooked["checks"]
    a, b = runs[None].retired, runs[ref].retired
    both = sorted(set(a) & set(b))
    assert len(both) >= 10
    assert all(list(a[r][1]) == list(b[r][1]) for r in both)


def test_references_are_found_by_file(tmp_path):
    assert {"llama", "mamba1"} <= set(references())
    (tmp_path / "moe_ref.py").write_text(
        "SMOKE = {'num_layers': 2}\n\n\ndef parameters(cfg):\n    return []\n")
    (tmp_path / "helper.py").write_text("def parameters(cfg):\n    pass\n")
    (tmp_path / "annotated.py").write_text(
        "SMOKE: dict = {}\n\n\ndef parameters(cfg):\n    pass\n")
    assert references(tmp_path) == ["annotated", "moe_ref"]
