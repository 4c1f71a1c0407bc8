"""``sparsify_clip_tpu_torch.utils.profiling`` against the JAX package's
``utils/profiling.py``, on the CPU: the throughput meter's numbers on the
same time stamps (exact), the Chrome trace of ``trace`` and the result of
``log_compile_time``.
"""

import json
import os

import pytest
import torch

from sparsify_clip_tpu.utils import profiling as jax_profiling
from sparsify_clip_tpu_torch import train
from sparsify_clip_tpu_torch.utils import profiling


def _run(module, monkeypatch, stamps, batches, window):
    clock = iter(stamps)
    monkeypatch.setattr(module.time, "perf_counter", lambda: next(clock))
    meter = module.ThroughputMeter(window=window, n_chips=2)
    readings = [(meter.pairs_per_sec, meter.step_time_ms)]
    meter.start()
    for b in batches:
        meter.step(b)
        readings.append((meter.pairs_per_sec, meter.pairs_per_sec_per_chip, meter.step_time_ms))
    monkeypatch.undo()
    return readings


@pytest.mark.parametrize("window", [3, 50])
def test_throughput_meter_equals_the_jax_meter(monkeypatch, window):
    stamps = [10.0, 10.5, 10.62, 10.71, 10.95, 11.0, 11.3, 11.31]
    batches = [256, 256, 128, 256, 64, 256, 256]
    want = _run(jax_profiling, monkeypatch, stamps, batches, window)
    got = _run(profiling, monkeypatch, stamps, batches, window)
    assert got == want
    assert got[-1][0] > 0


def test_the_train_loop_uses_the_meter():
    assert train.ThroughputMeter is profiling.ThroughputMeter
    assert profiling.ThroughputMeter().n_chips == max(torch.cuda.device_count(), 1)


def test_trace_writes_a_chrome_trace_with_a_cpu_op(tmp_path):
    x = torch.ones(64, 64)
    with profiling.trace(str(tmp_path / "t")) as prof:
        (x @ x).sum()
    files = os.listdir(tmp_path / "t")
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / "t" / files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    names = {e.get("name") for e in events if e.get("cat") == "cpu_op"}
    assert any(n in names for n in ("aten::mm", "aten::matmul"))
    assert any(e.key in ("aten::mm", "aten::matmul") for e in prof.key_averages())


def test_log_compile_time_returns_the_output_and_seconds():
    out, seconds = profiling.log_compile_time(lambda a, b: {"s": [a + b]}, torch.ones(3),
                                              torch.ones(3), label="add")
    assert torch.equal(out["s"][0], torch.full((3,), 2.0)) and seconds >= 0.0
    fenced = []
    out, _ = profiling.log_compile_time(lambda: 7, fence=fenced.append)
    assert out == 7 and fenced == [7]
