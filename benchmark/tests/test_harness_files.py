"""BENCHMARK.json against its schema, and every configuration,
traffic mix, limits file and metric reader found by its name; a new
configuration, cell and roofline metric added as new files alone."""
import json
import re
import shutil

import pytest

from benchmark.harness import arith
from benchmark.harness import main as hm
from benchmark.harness.trace import DeviceOp
from conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_entries_and_names():
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert (ROOT / c["file"]).exists()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for entry in (BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
                  + BENCH["per_layer"]):
        assert NAME.match(entry["name"]), entry["name"]
        names.add(entry["name"])
        if "unit" in entry:
            assert UNIT.match(entry["unit"]) and entry["better"] in (
                "lower", "higher")
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    spec = hm.load_cell(cell)
    assert spec["traffic"]["entry"] in ("sync", "train", "serve")
    assert hm.entry_class(spec["traffic"]).__name__ == "Cell"
    assert spec["limits"] and all(v >= 0 for v in spec["limits"].values())
    assert {"setup_s"} < {m["name"] for m in spec["end_to_end"]}
    assert spec["per_layer"]
    for m in spec["per_layer"]:
        assert callable(hm.load_reader(m["name"]))


READER = """
from benchmark.harness import arith
from benchmark.harness.readers import conv_bound_s, roofline


def read(ctx):
    if not ctx.get("levels"):
        return None
    bound = conv_bound_s(ctx, "split", [arith.split_forward])
    return roofline(ctx, bound, ["split_conv_kernel"])
"""


def test_a_cell_and_a_metric_added_as_files(tmp_path):
    """A throwaway configuration (DAGR-S with DAGR-L's stem widths), a
    cell on it, its limits and a roofline reader, written beside copies
    of the files that are there: found, the reader's bound worked out
    from the new configuration's conv routes, and no file edited."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*")
              if p.is_file()}
    cfg = json.loads((root / "benchmark/configs/dagr-s-dsec.json")
                     .read_text())
    (root / "benchmark/configs/wide-tmp.json").write_text(json.dumps(
        dict(cfg, net_stem_width=1.0, yolo_stem_width=1.0)))
    (root / "benchmark/workloads/sync-b2.json").write_text(json.dumps(
        dict(json.loads((root / "benchmark/workloads/sync-b1.json")
                        .read_text()), batch=2)))
    (root / "benchmark/limits/wide-tmp.sync-b2.json").write_text(
        json.dumps({"raw_rel_err": 1e-4, "det_mismatch": 0}))
    (root / "benchmark/metrics/roofline.split_fwd.infer.py").write_text(
        READER)
    bench["configs"].append({"name": "wide-tmp", "source": "a test",
                             "file": "benchmark/configs/wide-tmp.json",
                             "reduced": [], "why": "wider stems"})
    bench["workloads"].append({"name": "wide-tmp.sync-b2",
                               "config": "wide-tmp", "traffic": "sync-b2",
                               "chips": 1, "why": "two windows a request"})
    bench["per_layer"].append({"name": "roofline.split_fwd.infer",
                               "unit": "%", "better": "higher",
                               "source": "device_trace",
                               "layer": "kernels: csrc/spline_conv.cu",
                               "moves": "events_per_s",
                               "workloads": ["wide-tmp.sync-b2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = hm.load_cell("wide-tmp.sync-b2", root)
    assert spec["traffic"]["batch"] == 2
    assert spec["config"]["net_stem_width"] == 1.0
    assert [m["name"] for m in spec["per_layer"]] == [
        "roofline.split_fwd.infer"]
    cell = hm.entry_class(spec["traffic"])(spec, 1, "cpu")
    level = arith.Level(2000, 1800, 16000, 16)
    pooled = arith.Level(200, 160, 1000, 9)
    ctx = dict(cell.census([[level] + [pooled] * 4], [2], train=False),
               device_ops=[DeviceOp("split_conv_kernel", 0.0, 100.0)],
               units=1)
    split = [c for c in ctx["convs"] if c.route == "split"]
    assert len(split) == 12
    want = sum(arith.bound_s(*arith.split_forward(
        c, ([level] + [pooled] * 4)[c.level])) for c in split)
    got = hm.load_reader("roofline.split_fwd.infer", root)(ctx)
    assert got == pytest.approx(100.0 * want / 100e-6) and got > 0
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_configs_hold_the_published_widths():
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert (cfg["base_width"], cfg["after_pool_width"],
                cfg["net_stem_width"], cfg["yolo_stem_width"]) == (
            0.5, 1.0, 0.5, 0.5)
        assert (cfg["max_neighbors"], cfg["kernel_size"], cfg["radius"],
                cfg["n_nodes"], cfg["pooling_dim_at_output"]) == (
            16, 5, 0.01, 50000, "5x7")
        assert (cfg["height"], cfg["width"]) == (215, 320)
        assert cfg["reduced"] == c["reduced"] == []
