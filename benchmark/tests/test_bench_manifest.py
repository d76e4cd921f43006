"""``BENCHMARK.json`` against the benchmark's contract, and the files it names found by name."""

import json
import os
import re

import pytest

from benchmark import manifest as mf

M = mf.load_manifest()
CELLS = [w["name"] for w in M["workloads"]]
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head|_dim$|_rank$|expansion|experts_per_tok|"
                   r"num_experts_per)", re.I)


def test_top_level_keys_and_command():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert M["command"] == ["python3", "-m", "benchmark.run"] and len(M["command"]) <= 32
    assert M["paths"] == ["benchmark"]
    for p in M["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(mf.ROOT, p)) and not p.endswith("_torch")
    assert os.path.getsize(os.path.join(mf.ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_run_seconds_fits_the_check_with_24_cells():
    r = M["run_seconds"]
    assert isinstance(r, int) and 1 <= r <= 51
    assert (2 + 14 * 24) * (r + 60) + 24 * 2 * 90 + 1200 <= 43200


def _names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in M[group]:
            yield group, entry


@pytest.mark.parametrize("group,entry", list(_names()), ids=lambda v: v if isinstance(v, str) else v["name"])
def test_entry_keys_names_and_units(group, entry):
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}[group]
    extra = set(entry) - keys
    assert set(entry) >= keys and extra <= ({"workloads"} if group in ("end_to_end", "per_layer") else set())
    assert mf.NAME.match(entry["name"])
    for text in ("why", "layer", "source"):
        if text in entry:
            assert 1 <= len(entry[text]) <= 200 and "\n" not in entry[text] and "\t" not in entry[text]
    if group in ("end_to_end", "per_layer"):
        assert mf.UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
        assert entry["source"] in (("host_clock", "device_trace") if group == "end_to_end" else
                                   ("device_trace", "program_span", "program_counter", "host_clock"))
        assert set(entry.get("workloads", CELLS)) <= set(CELLS)
    if group == "end_to_end":
        assert 0.01 <= entry["bound"] <= 0.25
    if group == "per_layer":
        assert entry["moves"] in {m["name"] for m in M["end_to_end"]}
        if entry["name"].endswith("_roofline") or "_roofline." in entry["name"] or "mfu" in entry["name"]:
            assert entry["unit"] == "%"
    if group == "workloads":
        assert entry["chips"] in (1, 4) and mf.NAME.match(entry["config"]) and mf.NAME.match(entry["traffic"])
    if group == "configs":
        assert len(entry["reduced"]) <= 16
        assert all(mf.NAME.match(k) and not WIDTH.search(k) for k in entry["reduced"])
        assert entry["file"].startswith("benchmark/") and os.path.isfile(os.path.join(mf.ROOT, entry["file"]))


def test_names_are_unique_and_every_config_is_used():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in M[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in M["end_to_end"] + M["per_layer"]]
    assert len(metrics) == len(set(metrics))
    assert {w["config"] for w in M["workloads"]} == {c["name"] for c in M["configs"]}
    assert len({(w["config"], w["traffic"]) for w in M["workloads"]}) == len(M["workloads"])
    assert len({c["file"] for c in M["configs"]}) == len(M["configs"])
    assert sum(w["chips"] == 4 for w in M["workloads"]) <= max(1, len(M["workloads"]) // 4)


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_finds_its_files_and_reports_enough(cell):
    spec = mf.cell_spec(M, cell)
    e2e = {m["name"] for m in spec.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and spec.per_layer
    for m in spec.per_layer:
        assert m["moves"] in e2e
        assert callable(mf.metric_reader(m["name"]))
    assert mf.driver(spec.traffic["driver"]).run
    kinds = {"alg_step", "cfg_step"} if spec.traffic["alg"].get("use_low_pass_guidance") else {"cfg_step"}
    assert set(spec.limits) == {f"{k}.{n}" for k in kinds for n in ("l2", "max", "pass_l2", "pass_max")}
    assert all(0 < v < 1e3 for v in spec.limits.values())


@pytest.mark.parametrize("entry", M["configs"], ids=lambda c: c["name"])
def test_config_file_holds_the_ports_preset_apart_from_what_it_names_as_reduced(entry):
    """The configuration as run is the port's preset of the published model: every number of its
    transformer and VAE, with only the keys ``reduced`` lists left out or changed."""
    from alg_tpu_torch.io import hf_checkpoint

    cfg = json.load(open(os.path.join(mf.ROOT, entry["file"])))
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert set(cfg["reduced"]) == set(entry["reduced"])
    preset = getattr(hf_checkpoint, cfg["preset"].rsplit(".", 1)[1])
    for group in ("transformer", "vae"):
        for key, value in preset[group].items():
            if key not in entry["reduced"]:
                assert cfg[group][key] == value, (group, key)
    assert "text_encoder" in entry["reduced"] and "text_encoder" not in cfg
    sched = {k: v for k, v in hf_checkpoint.COGVIDEOX_SCHEDULER.items() if k != "_class_name"}
    assert cfg["scheduler"] == {**sched, **preset.get("scheduler", {})}
    assert cfg["dtypes"] == {"transformer": "bfloat16", "vae": "float32"}


def test_per_layer_layers_are_named_alike():
    layers = {m["layer"] for m in M["per_layer"]}
    assert layers <= {"pipeline", "model step", "kernels", "GEMMs", "device"}
