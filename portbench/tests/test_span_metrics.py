"""The per-layer metrics that read the port's span record (source
``program_span``), on the CPU:

* each is found by name in ``BENCHMARK.json`` and reads a made-up record
  to the number worked out by hand;
* none raises where the program keeps no record (the module not loaded,
  or loaded without ``record``) or lacks the span: each gives None;
* a traced CPU run of a small cell of each kind reports its cell's span
  metrics, and the forwards' chunks are the ones the audio needs.
"""

import math
import sys
import types

import pytest
import torch

from portbench import bench, program, spec, spans
from portbench.tests.test_portbench import SEED, small_cell

CPU = torch.device("cpu")
SPAN_METRICS = {
    "k1_host_us_per_stage.transcribe": ("K1", "transcribe_rtf"),
    "glue_host_ms_per_audio_s.transcribe": ("streaming", "transcribe_rtf"),
    "chunks_per_audio_s.transcribe": ("streaming", "transcribe_rtf"),
    "chunks_per_audio_s.reconstruct": ("streaming", "reconstruct_rtf"),
    "update_host_ms_per_step.train": ("train step", "train_step_ms"),
    "rebuild_host_ms_per_step.train": ("train step", "train_step_ms"),
}


def _entry(count, total_s, self_s=None, items=None):
    return {"count": count, "items": count if items is None else items,
            "total_s": total_s,
            "self_s": total_s if self_s is None else self_s}


RECORD = {
    "tt.transcribe": _entry(4, 2.0, self_s=0.1),
    "tt.forward": _entry(36, 1.9, self_s=0.2, items=140),
    "tt.analysis": _entry(36, 0.05),
    "tt.overlap_add": _entry(36, 0.04),
    "tt.stream.wait": _entry(8, 0.01),
    "tt.skip.add": _entry(8, 0.005),
    "tt.chain": _entry(36, 1.6, self_s=0.02),
    "tt.k1": _entry(2160, 1.58),
    "tt.k2": _entry(4, 0.001),
    "tt.prepare": _entry(3, 0.002),
    "tt.build": _entry(1, 0.5),
    "tt.spec_build": _entry(2, 0.01),
    "tt.step.update": _entry(5, 0.1),
    "window": _entry(1, 10.0),
}
CTX = {"work": {"audio_s": 200.0, "steps": 5}, "trace": {"window_s": 10.0}}
WANT = {
    "k1_host_us_per_stage.transcribe": 1e6 * 1.58 / 2160,
    "glue_host_ms_per_audio_s.transcribe":
        1e3 * (0.1 + 0.2 + 0.05 + 0.04 + 0.01 + 0.005) / 200.0,
    "chunks_per_audio_s.transcribe": 140 / 200.0,
    "chunks_per_audio_s.reconstruct": 140 / 200.0,
    "update_host_ms_per_step.train": 1e3 * 0.1 / 5,
    "rebuild_host_ms_per_step.train": 1e3 * (0.01 + 0.002) / 5,
}


def _program(monkeypatch, rec):
    module = types.ModuleType(spans.MODULE)
    if rec is not None:
        module.record = lambda: rec
    monkeypatch.setitem(sys.modules, spans.MODULE, module)


def test_each_span_metric_is_an_entry_and_reads_a_record(monkeypatch):
    entries = {m["name"]: m for m in spec.load_benchmark()["per_layer"]}
    cells = {w["name"]: w for w in spec.load_benchmark()["workloads"]}
    layers = {m["layer"] for name, m in entries.items()
              if name not in SPAN_METRICS}
    _program(monkeypatch, RECORD)
    for name, (layer, moves) in SPAN_METRICS.items():
        m = entries[name]
        assert m["source"] == "program_span" and m["moves"] == moves
        assert m["layer"].startswith(layer) and m["layer"] in layers
        assert m["workloads"] and set(m["workloads"]) <= set(cells)
        got = spec.metric_reader(name)(CTX)
        assert got == pytest.approx(WANT[name], rel=1e-12), name


@pytest.mark.parametrize("rec", [None, {}, {"tt.other": _entry(1, 1.0)}])
def test_without_the_record_or_the_span_each_reads_none(monkeypatch, rec):
    """The program without the record (the module without ``record``), an
    empty record, a record without the metric's spans: None, no raise."""
    _program(monkeypatch, rec)
    for name in SPAN_METRICS:
        assert spec.metric_reader(name)(CTX) is None, name


def test_without_the_module_each_reads_none(monkeypatch):
    monkeypatch.delitem(sys.modules, spans.MODULE, raising=False)
    for name in SPAN_METRICS:
        assert spec.metric_reader(name)(CTX) is None, name


@pytest.mark.parametrize("kind", ["transcribe", "reconstruct", "train"])
def test_a_traced_cpu_run_reports_its_span_metrics(kind):
    from timbre_trap_tpu_torch.utils import profiling

    cell = small_cell(kind)
    want = {m["name"] for m in cell.per_layer} & set(SPAN_METRICS)
    assert want
    profiling.reset_record()
    r = bench.run(cell, SEED, 0.1, True, CPU, program)
    assert r["correct"], r["checks"]
    got = {k: v["value"] for k, v in r["metrics"].items()}
    for name in want:
        assert math.isfinite(got[name]) and got[name] >= 0, name
    rec = spans.record()
    if kind == "train":
        assert rec["tt.step.update"]["count"] == r["attempted"]
        assert got["rebuild_host_ms_per_step.train"] > 0
        return
    # The chunks the forwards ran: 2 a block and 1 more for a clip of one
    # pass; a streamed clip (two pieces or more) runs whole pieces, each
    # 2 a block of the piece and 1 more.
    m = cell.config["model"]
    block = int(m["secs_per_block"] * m["sample_rate"])
    plan = bench.gen.clip_plan(cell.traffic, m["sample_rate"], SEED)
    chunks = 0
    for i in range(r["attempted"]):
        blocks = -(-plan[i % len(plan)][1] // block)
        pieces = -(-blocks // 16)
        chunks += pieces * 33 if pieces >= 2 else 2 * blocks + 1
    assert rec["tt.forward"]["items"] == chunks
