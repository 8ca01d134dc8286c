"""Each cell rehearsed on the CPU at a tiny size through the test-only
entry (``run_cell`` with ``device="cpu"``): the window, the traffic, the
work count and the comparison with the reference run, and the result's
line has every key the contract asks for."""

import json

import pytest

from bench_port.harness import common
from bench_port.tests.small import cells, rehearse


@pytest.mark.parametrize("cell", cells())
def test_cell_rehearsal_is_correct(cell):
    result, judged = rehearse(cell)
    assert result["correct"], (result, judged)
    assert result["attempted"] > 0 and result["failed"] == 0
    want = {m["name"] for m in common.cell_metrics(common.manifest(), cell,
                                                   False)}
    assert set(result["metrics"]) == want
    assert {"setup_s", "peak_mem_gib"} <= want
    for name, m in result["metrics"].items():
        assert m["unit"]
        # the CPU has no device memory counter: its peak reads 0
        assert m["value"] > 0 or name == "peak_mem_gib"
    assert result["device"]["memory_peak_bytes"] == 0
    limits = common.workload(cell)["limits"]
    assert set(judged) == set(limits)
    json.dumps(result)


@pytest.mark.parametrize("cell", ["flagship_fp32.eval", "flagship_fp32.train"])
def test_traced_rehearsal_reads_its_metrics(cell):
    result, _ = rehearse(cell, trace=True)
    assert result["correct"]
    names = {m["name"] for m in common.cell_metrics(common.manifest(), cell,
                                                    True)}
    assert set(result["metrics"]) <= names
    # the CPU has no device trace: the device's shares say so, they are
    # not zero
    assert any(n.startswith("mfu.") for n in result["metrics"])
    dev = result["device"]
    assert dev["window_s"] > 0 and dev["busy_s"] == 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_every_cell_and_metric_has_its_files():
    bench = common.manifest()
    for cell in bench["workloads"]:
        wl = common.workload(cell["name"])
        assert wl["config"] == cell["config"]
        common.model_config(wl["config"])
    for m in bench["per_layer"]:
        from bench_port.tests.small import run_module
        reader = run_module().load_reader(m["name"])
        assert callable(reader.read)


def test_capture_reader_reads_the_train_entry_host_key():
    from types import SimpleNamespace

    from bench_port.tests.small import run_module
    reader = run_module().load_reader("graph_capture_s.train")
    assert reader.read(SimpleNamespace(host={"graph_capture_s": 3.5})) == 3.5
    assert reader.read(SimpleNamespace(host={})) is None
    with open(reader.__file__.replace("metrics/graph_capture_s.train.py",
                                      "entries/train.py")) as fh:
        assert '"graph_capture_s"' in fh.read()
