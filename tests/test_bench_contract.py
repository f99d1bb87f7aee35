"""Contract tests for bench.py: complete JSON lines naming the device,
deadline-gated sections, no measurement without an accelerator, and the
device timer."""

import importlib.util
import json
import os

import pytest

GPU = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}


def load_bench():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "bench.py")
    spec = importlib.util.spec_from_file_location("bench_module", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stub_all(monkeypatch, bench):
    monkeypatch.setattr(bench, "_device_info", lambda: dict(GPU))
    monkeypatch.setattr(bench, "_card", lambda: "NVIDIA H100, 400.00 W")
    monkeypatch.setattr(bench, "bench_embed_int8", lambda *a, **k: {
        "int8": 3000.0, "int8_spread": [2990.0, 3010.0], "_ctx": {}})
    monkeypatch.setattr(bench, "bench_embed_bf16", lambda *a, **k: {
        "bf16": 3500.0, "bf16_spread": [3490.0, 3510.0],
        "int8_cosine_min": 0.9997})
    monkeypatch.setattr(bench, "bench_search",
                        lambda kind, **k: (8000.0, [7900.0, 8100.0], 1.0))
    monkeypatch.setattr(bench, "bench_recall_parity", lambda *a, **k: 1.0)
    monkeypatch.setattr(bench, "bench_finetune_step", lambda *a, **k: {
        "ms": 30.0, "ms_spread": [29.0, 31.0], "img_per_s": 2133.0})
    monkeypatch.setattr(bench, "bench_hyp_train", lambda *a, **k: 450.0)


def test_bench_json_schema(monkeypatch, capsys):
    """main() emits progressively richer complete JSON lines (consumers
    take the LAST); every line parses and names the device."""
    bench = load_bench()
    _stub_all(monkeypatch, bench)
    assert bench.main() == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) >= 2, "expect a first line + progressive updates"
    for line in out:
        assert json.loads(line)["device"] == GPU
    payload = json.loads(out[-1])
    assert set(payload) >= {"metric", "value", "unit", "precision",
                            "device"}
    assert "vs_baseline" not in payload
    assert payload["unit"] == "images/sec/device"
    assert payload["value"] == 3000.0
    ex = payload["extras"]
    assert ex["status"] == "complete"
    assert ex["card"] == "NVIDIA H100, 400.00 W"
    assert ex["recall10_parity_vs_bruteforce"] == 1.0
    assert ex["embed_bf16_ips"] == 3500.0
    assert ex["topk_qps_1M_int8"] == 8000.0
    assert ex["topk_1M_poincare_parity_vs_scan"] == 1.0
    assert ex["finetune_step_ms_b32pairs"] == 30.0
    assert ex["hyp_train_steps_per_sec"] == 450.0
    assert ex["skipped"] == []


def test_bench_deadline_skips_sections(monkeypatch, capsys):
    """With an exhausted deadline, sections are skipped and RECORDED as
    skipped — the last line still lands."""
    bench = load_bench()
    _stub_all(monkeypatch, bench)
    monkeypatch.setenv("PATENT_BENCH_DEADLINE_S", "0")
    called = []
    monkeypatch.setattr(bench, "bench_embed_int8",
                        lambda *a, **k: called.append("embed"))
    bench.main()
    payload = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert called == [], "no section should run past the deadline"
    assert "embed_int8" in payload["extras"]["skipped"]
    assert "hyp_train" in payload["extras"]["skipped"]


def test_bench_refuses_without_accelerator(monkeypatch, capsys):
    """No accelerator: one error line, exit 1, and no section runs — a
    CPU number is never reported under a device metric."""
    bench = load_bench()
    _stub_all(monkeypatch, bench)
    monkeypatch.setattr(bench, "_device_info", lambda: {
        "platform": "cpu", "kind": "cpu", "count": 1})
    called = []
    monkeypatch.setattr(bench, "bench_embed_int8",
                        lambda *a, **k: called.append("embed"))
    assert bench.main() == 1
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and called == []
    payload = json.loads(out[0])
    assert payload["value"] == 0.0
    assert "no accelerator" in payload["extras"]["error"]


def test_bench_section_errors_are_recorded(monkeypatch, capsys):
    """A section that raises is recorded and the run goes on; a missing
    optional dependency is recorded as a skip."""
    bench = load_bench()
    _stub_all(monkeypatch, bench)

    def boom(*a, **k):
        raise RuntimeError("out of memory")

    def no_flax(*a, **k):
        raise ImportError("No module named 'flax'")

    monkeypatch.setattr(bench, "bench_finetune_step", boom)
    monkeypatch.setattr(bench, "bench_hyp_train", no_flax)
    bench.main()
    payload = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    ex = payload["extras"]
    assert ex["finetune_step_error"] == "RuntimeError: out of memory"
    assert ex["status"].startswith("complete_with_errors")
    assert any(s.startswith("hyp_train:") for s in ex["skipped"])
    assert ex["topk_qps_1M_poincare"] == 8000.0   # later sections ran


def test_timed_throughput_waits_for_device(monkeypatch):
    """Each timed call ends in block_until_ready (the device, not the
    enqueue, is timed), after one untimed warm-up call."""
    from patent_tpu.utils import timing

    waited = []
    monkeypatch.setattr(timing.jax, "block_until_ready",
                        lambda x: waited.append(x) or x)
    calls = iter(range(100))
    rate = timing.timed_throughput(lambda: next(calls), units_per_iter=4,
                                   iters=5)
    assert waited == [0, 1, 2, 3, 4, 5]
    assert rate > 0


def test_timed_seconds_per_iter_clock(monkeypatch):
    """Host clock around the timed window, divided by the iterations."""
    from patent_tpu.utils import timing

    times = iter([10.0, 12.0])
    monkeypatch.setattr(timing.time, "perf_counter", lambda: next(times))
    assert timing.timed_seconds_per_iter(lambda: None, iters=4) == \
        pytest.approx(0.5)


def test_timed_spread_reports_median_and_range(monkeypatch):
    from patent_tpu.utils import timing

    rates = iter([3.0, 1.0, 2.0])
    monkeypatch.setattr(timing, "timed_throughput",
                        lambda fn, units, iters: next(rates))
    med, spread = timing.timed_spread(lambda: None, 1, reps=3)
    assert med == 2.0 and spread == [1.0, 3.0]
