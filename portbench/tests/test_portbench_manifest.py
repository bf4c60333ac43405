"""``BENCHMARK.json`` against the form it must keep, and every file it names
found by name."""

import json
import re

from portbench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                   r"projection|head|expan|experts_per_tok|size")


def data():
    return json.loads((manifest.ROOT / "BENCHMARK.json").read_text())


def line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and \
        "\n" not in text and "\t" not in text


def test_keys_and_size():
    d = data()
    assert set(d) == KEYS
    assert (manifest.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= d["run_seconds"] <= 51 and isinstance(d["run_seconds"], int)
    assert 1 <= len(d["command"]) <= 32 and all(line(w) for w in d["command"])
    assert 1 <= len(d["paths"]) <= 16
    for p in d["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p


def test_full_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    total = runs * (data()["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_names_units_and_lines():
    d = data()
    names = [c["name"] for c in d["configs"]] + \
        [w["name"] for w in d["workloads"]] + \
        [m["name"] for m in d["end_to_end"] + d["per_layer"]]
    assert all(NAME.match(n) for n in names)
    assert len(set(c["name"] for c in d["configs"])) == len(d["configs"])
    assert len(set(w["name"] for w in d["workloads"])) == len(d["workloads"])
    metrics = d["end_to_end"] + d["per_layer"]
    assert len(set(m["name"] for m in metrics)) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for w in d["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and line(w["why"]) and NAME.match(
            w["traffic"]) and NAME.match(w["config"])
    assert len({(w["config"], w["traffic"]) for w in d["workloads"]}) == \
        len(d["workloads"])
    for c in d["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert line(c["source"]) and line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k)
                                               for k in c["reduced"])


def test_end_to_end_bounds():
    d = data()
    e2e = {m["name"]: m for m in d["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in d["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_every_file_is_found_by_name():
    bench = manifest.Manifest()
    d = data()
    for c in d["configs"]:
        path = manifest.ROOT / c["file"]
        assert path.exists() and c["file"].startswith(tuple(d["paths"]))
        conf = json.loads(path.read_text())
        assert conf["source"] == c["source"]
        for key in c["reduced"]:
            assert key in conf and not WIDTH.search(key), key
    assert len({c["file"] for c in d["configs"]}) == len(d["configs"])
    used = {w["config"] for w in d["workloads"]}
    assert used == set(bench.configs)
    for w in d["workloads"]:
        traffic = bench.traffic(w["traffic"])
        manifest.load_module("drivers", traffic["driver"])
        assert bench.limits(w["name"])["numbers"]
    for m in d["end_to_end"] + d["per_layer"]:
        assert callable(manifest.load_module("metrics", m["name"]).read)


def test_every_cell_reports_enough():
    bench = manifest.Manifest()
    d = data()
    for w in d["workloads"]:
        e2e = bench.end_to_end_of(w["name"])
        assert "setup_s" in e2e and len(e2e) >= 2
        assert bench.per_layer_of(w["name"])
    for m in d["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert line(m["layer"])
        assert m["moves"] in {e["name"] for e in d["end_to_end"]}
        for cell in m["workloads"]:
            assert m["moves"] in bench.end_to_end_of(cell), (m, cell)
    for m in d["per_layer"]:
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
