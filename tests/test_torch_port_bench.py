"""The port's headline benchmark (``bench.py``) and FLOP models
(``obs/flops.py``) against the JAX package's.

The FLOP models must give JAX's numbers; the ``kind: "bench"`` record
must carry exactly the keys of the JAX headline's (root ``bench.py``,
its measurement patched out); MFU is null off a card with a known peak;
a tiny measurement on the CPU trains the headline configuration and
returns a positive rate. The full batches run only on the card
(``chip_smoke.py``).
"""

import importlib.util
import json
import os
import sys

import pytest

from cs744_pytorch_distributed_tutorial_tpu_torch import bench
from cs744_pytorch_distributed_tutorial_tpu_torch.obs import flops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_flops_match_jax():
    from cs744_pytorch_distributed_tutorial_tpu.obs import flops as jax_flops

    assert flops.resnet18_cifar_train_flops_per_sample() == 3_332_536_320.0
    assert (flops.resnet18_cifar_train_flops_per_sample()
            == jax_flops.resnet18_cifar_train_flops_per_sample())
    for n in (1, 124_439_808, 162_286_080.0):
        assert (flops.transformer_train_flops_per_token(n)
                == jax_flops.transformer_train_flops_per_token(n))


@pytest.mark.parametrize("name,peak", [
    ("NVIDIA H100 80GB HBM3", 989e12),
    ("NVIDIA H100 PCIe", 756e12),
    ("NVIDIA H100 NVL", None),
    ("NVIDIA A100-SXM4-80GB", None),
    ("cpu", None),
    ("TPU v5 lite", None),  # the card's own peaks only
])
def test_mfu_against_the_cards_peak(name, peak):
    assert flops.peak_flops_per_card(name) == peak
    got = flops.mfu(0.5e15, name)
    assert got is None if peak is None else got == pytest.approx(0.5e15 / peak)
    assert (flops.card_peaks(name) is None) == (peak is None)


def _jax_bench_record(monkeypatch, capsys) -> dict:
    spec = importlib.util.spec_from_file_location("jax_root_bench", os.path.join(REPO, "bench.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    monkeypatch.setattr(module, "_bench_at", lambda batch, steps=30, **kw: (1000.0, 0))
    monkeypatch.setattr(sys, "argv", ["bench.py"])
    module.main()
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_bench_record_and_cpu_measurement(monkeypatch, capsys, tmp_path):
    want = _jax_bench_record(monkeypatch, capsys)
    m = bench.bench_at(4, 2, device="cpu", warmup=1)
    assert m["samples_per_sec"] > 0 and m["wire_bytes"] == 0
    assert m["peak_memory_bytes"] is None and m["device"].type == "cpu"
    rec = bench.headline_record(m, m)
    assert set(rec) == set(want)
    assert rec["kind"] == want["kind"] == "bench"
    assert rec["metric"] == want["metric"] and rec["unit"] == want["unit"]
    assert rec["batch"] == want["batch"] == 4096
    assert rec["flops_per_sample"] == want["flops_per_sample"]
    assert rec["mfu"] is None and rec["vs_baseline"] is None and rec["vs_baseline_b1024"] is None

    sink = bench._make_sink(str(tmp_path / "metrics"))
    sink.emit(rec)
    sink.close()
    line = (tmp_path / "metrics" / "metrics.jsonl").read_text().splitlines()[-1]
    assert json.loads(line)["value"] == rec["value"]
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["kind"] == "bench"


@pytest.mark.parametrize("flag", [["--serve", "--requests", "4"]])
def test_unported_modes_exit(flag, monkeypatch, tmp_path, capsys):
    """``--serve`` (the bench's one mode that once exited "not yet
    ported") hands the rest of the line to ``serve_cli.main``, with a
    ``--metrics-dir`` given before ``--serve`` appended, as the JAX root
    ``bench.py`` does, and returns its exit code; then a real run of it on
    the CPU writes its serve_summary to that metrics dir."""
    from cs744_pytorch_distributed_tutorial_tpu_torch import serve_cli

    seen = []
    with monkeypatch.context() as mp:
        mp.setattr(serve_cli, "main", lambda argv: seen.append(argv) or 7)
        assert bench.main(["--metrics-dir", str(tmp_path), *flag]) == 7
        assert bench.main([*flag, "--metrics-dir", "elsewhere"]) == 7
    assert seen == [[*flag[1:], "--metrics-dir", str(tmp_path)],
                    [*flag[1:], "--metrics-dir", "elsewhere"]]
    tiny = ["--num-layers", "1", "--d-model", "16", "--num-heads", "2", "--d-ff", "32",
            "--vocab-size", "64", "--max-seq-len", "32", "--use-rope", "--rate", "200",
            "--prompt-len", "3", "6", "--output-len", "2", "4", "--num-slots", "2",
            "--page-size", "4", "--num-pages", "12", "--max-pages-per-slot", "4",
            "--device", "cpu"]
    assert bench.main(["--metrics-dir", str(tmp_path), *flag, *tiny]) == 0
    capsys.readouterr()
    rows = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    (summary,) = [r for r in rows if r.get("kind") == "serve_summary"]
    assert summary["requests"] == summary["completed"] == 4


class _FakeReport:
    """The fields of a PhaseReport the JAX bench reads."""

    fused_ms, sync_exposed_ms, parity_ok = 10.0, 0.5, True

    def records(self, run="phase"):
        return [{"kind": "phase", "run": run}, {"kind": "phase_summary", "run": run}]

    def table(self):
        return ""


def _jax_mode_records(monkeypatch, mode: str) -> dict:
    """The JAX bench's records of ``mode``, its measurements patched out:
    the keys of each record kind."""
    spec = importlib.util.spec_from_file_location("jax_root_bench", os.path.join(REPO, "bench.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    monkeypatch.setattr(module, "_bench_at", lambda batch, steps=30, **kw: (1000.0, 0))
    monkeypatch.setattr(module, "_phase_report", lambda batch, **kw: (_FakeReport(), 1))
    sink = _ListSink()
    if mode == "phase_breakdown":
        module.phase_breakdown(sink, 8)
    else:
        module.sync_compare(sink)
    return _keys_by_kind(sink.records)


class _ListSink:
    def __init__(self):
        self.records = []

    def emit(self, rec):
        self.records.append(rec)


def _keys_by_kind(records) -> dict:
    out = {}
    for r in records:
        out.setdefault(r["kind"], []).append(set(r))
    return out


@pytest.mark.parametrize("mode", ["phase_breakdown", "sync_compare"])
def test_modes_run_on_cpu_with_the_jax_records(mode, monkeypatch, tmp_path, capsys):
    """Each mode on the CPU (tiny_cnn at batch 8, one timed call a phase),
    its record kinds and keys the JAX bench's. At a world of one
    ``sync_compare`` stops at zero1's phase pair, as JAX's does, after its
    four bench records and the two pure data-parallel pairs."""
    want = _jax_mode_records(monkeypatch, mode)
    sink = _ListSink()
    if mode == "phase_breakdown":
        assert bench.main(["--phase-breakdown", "--batch", "8", "--model", "tiny_cnn",
                           "--phase-iters", "1", "--device", "cpu", "--compute-dtype",
                           "float32", "--metrics-dir", str(tmp_path)]) == 0
        lines = capsys.readouterr().out.strip().splitlines()
        sink.records = [json.loads(line) for line in lines]
        saved = json.loads((tmp_path / "phase_report.json").read_text())
        assert [r["kind"] for r in saved] == ["phase"] * 4 + ["phase_summary"]
        assert sink.records[-1]["parity_ok"] is True
        assert [r["kind"] for r in sink.records] == ["phase"] * 4 + ["phase_summary", "bench"]
    else:
        with pytest.raises(ValueError, match="bucket"):
            bench.sync_compare(sink, batch=8, steps=1, phase_iters=1, device="cpu", warmup=1,
                               model="tiny_cnn")
        assert [r["kind"] for r in sink.records] == ["bench"] * 4 + ["sync_compare"] * 2
        assert all(r["parity_ok"] for r in sink.records[4:])
        want["sync_compare"] = want["sync_compare"][:2]
    got = _keys_by_kind(sink.records)
    assert set(got) == set(want)
    for kind in got:
        if kind in ("phase", "phase_summary"):
            continue  # their keys are held by tests/test_torch_port_phases.py
        assert got[kind] == want[kind], kind


def test_bench_without_gpu_raises():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        bench.bench_at(8, 1)
