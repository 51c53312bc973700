"""BENCHMARK.json names every piece, each piece is a file found by name,
and a configuration, a traffic mix and a per-layer metric can be added as
new files alone."""

import json
import os
import re
import time

import pytest
import torch

from benchmark.harness.main import run_cell
from benchmark.harness.registry import BENCH_DIR, Registry

from .conftest import small_bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = Registry().spec()


def test_spec_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
    for w in SPEC["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_finds_its_files(cell):
    reg = Registry()
    wl = reg.workload(cell)
    config = reg.config(wl["config"])
    assert os.path.join(BENCH_DIR, "configs", f"{wl['config']}.json") \
        .endswith(next(c["file"] for c in SPEC["configs"]
                       if c["name"] == wl["config"]).split("benchmark/")[1])
    kind = reg.kind(reg.traffic(wl["traffic"])["kind"])
    assert set(kind.produces) <= {"container", "image"} and kind.produces
    assert reg.limits(cell)
    assert config["reduced"] == []
    e2e = reg.metrics_of(cell, False)
    layer = reg.metrics_of(cell, True)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert layer
    for m in e2e + layer:
        assert callable(reg.metric_reader(m["name"]))


def test_unknown_names_raise():
    reg = Registry()
    for find in (reg.workload, reg.config, reg.traffic, reg.limits,
                 reg.metric_reader, reg.kind):
        with pytest.raises(KeyError):
            find("no-such-name")


def test_one_reader_serves_a_formula_for_several_cells():
    reg = Registry()
    assert reg.metric_reader("idle_share.encode") is not None
    assert reg.metric_reader("idle_share.some-later-cell").__module__ \
        == reg.metric_reader("idle_share.decode").__module__
    with pytest.raises(KeyError):
        reg.metric_reader("no_formula.encode")


def _last_json(capsys):
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])


def test_new_pieces_are_files_alone(tmp_path, capsys):
    """A later change adds a deployment, a mix, a metric and a cell's
    limits as files, and one cell to BENCHMARK.json; no existing file of
    the harness is edited."""
    torch.set_num_threads(2)
    reg = small_bench(tmp_path)
    b = tmp_path / "benchmark"
    cfg = json.loads((b / "configs" / "live-ycocg-q20-80-b4-128.json")
                     .read_text())
    cfg.update(name="tiny-ycbcr", codec=dict(cfg["codec"],
                                             color_space="YCbCr",
                                             block_size_range=[4, 16]))
    (b / "configs" / "tiny-ycbcr.json").write_text(json.dumps(cfg))
    (b / "traffic" / "one-by-one.json").write_text(json.dumps(
        {"kind": "encode_stream", "batch_size": 1, "lookahead": 1,
         "repeat": 1, "warm_calls": 1, "warm_seconds": 0, "sample": 2,
         "profile_seconds": 0.1}))
    (b / "metrics" / "calls_in_window.py").write_text(
        "def read(ctx):\n    return float(len(ctx.calls))\n")
    (b / "limits" / "tiny.one-by-one.json").write_text(json.dumps(
        {"leaf_mismatch": 0.002, "level_mismatch": 3e-05}))
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny-ycbcr", "source": "x",
                            "file": "benchmark/configs/tiny-ycbcr.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "tiny.one-by-one",
                              "config": "tiny-ycbcr",
                              "traffic": "one-by-one", "chips": 1,
                              "why": "x"})
    spec["end_to_end"][0]["workloads"].append("tiny.one-by-one")
    spec["per_layer"].append({"name": "calls_in_window", "unit": "calls",
                              "better": "higher", "source": "host_clock",
                              "layer": "codec/stream.py",
                              "moves": "encode_mpix_s",
                              "workloads": ["tiny.one-by-one"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    rc = run_cell(reg, "tiny.one-by-one", 5, 0.3, True, time.perf_counter(),
                  device=torch.device("cpu"), look_for_chip=False)
    res = _last_json(capsys)
    assert rc == 0 and res["correct"] is True
    assert res["metrics"]["calls_in_window"]["value"] >= 1
    assert list(res)[-1] == "checks"


def test_no_cuda_no_result(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run_cell(small_bench(tmp_path), "clic.encode-stream", 1, 0.1,
                  False, time.perf_counter())
    assert rc != 0 and capsys.readouterr().out == ""
