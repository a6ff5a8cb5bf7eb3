"""A later change adds a configuration, a cell, a traffic kind or a
per-layer metric by new files and entries alone: the harness finds each
by its name, with no file it already has edited."""

from __future__ import annotations

import json
import shutil

from benchmark import harness
from benchmark.count import counts
from benchmark.tests.conftest import HERE, make_root, tiny_spec

DRIVER = '''"""Every request served twice in a row (a new traffic kind)."""

from benchmark.serve import ServeDriver, control  # noqa: F401


class Driver(ServeDriver):
    NAME = "predict_twice"

    def call(self, i):
        self.predictor.predict_batch(self.rgb[i], self.sparse[i])
        return self.predictor.predict_batch(self.rgb[i], self.sparse[i])
'''

METRIC = '''"""Requests in the traced stretch (a new per-layer metric)."""


def read(record):
    return float(record["calls"])
'''


def test_new_files_are_found_by_name(tmp_path):
    root = make_root(tmp_path / "bench")
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    conf = json.loads((HERE / "data" / "tiny.json").read_text())
    conf["name"] = "tiny_wide"
    conf["data"].update(height=32, width=64)
    conf["port"]["overrides"].update({"data.height": 32, "data.width": 64})
    conf["counts"] = counts(conf)
    (root / "configs" / "tiny_wide.json").write_text(json.dumps(conf))
    work = json.loads((root / "workloads" / "tiny-serve-b2.json").read_text())
    work.update(name="tiny-new", config="tiny_wide", driver="serve_twice")
    (root / "workloads" / "tiny-new.json").write_text(json.dumps(work))
    (root / "traffic" / "serve_twice.py").write_text(DRIVER)
    (root / "metrics" / "calls_traced.test.py").write_text(METRIC)
    spec = tiny_spec()
    spec["workloads"].append({"name": "tiny-new", "config": "tiny_wide",
                              "traffic": "serve_twice", "chips": 1})
    spec["end_to_end"].append({"name": "serve_img_per_s", "unit": "images/s",
                               "better": "higher", "bound": 0.05,
                               "source": "host_clock",
                               "workloads": ["tiny-new"]})
    spec["per_layer"].append({"name": "calls_traced.test", "unit": "calls",
                              "better": "higher", "source": "program_span",
                              "layer": "Serving", "moves": "serve_img_per_s",
                              "workloads": ["tiny-new"]})
    for trace in (0, 1):
        result, _ = harness.run("tiny-new", 5, 0.5, bool(trace), "cpu", 0.0,
                                where=root, bench=spec)
        assert result["correct"] is True
        if trace:
            assert result["metrics"]["calls_traced.test"]["value"] == 2.0
        else:
            assert "serve_img_per_s" in result["metrics"]
    after = {p: p.read_bytes() for p in before}
    assert after == before
    shutil.rmtree(root)
