"""chip_smoke.py on the CPU backend: every phase at tiny sizes, the GPU gate
and the contract of its last line.  The full-size run needs the GPU (the
``gpu``-marked test at the end)."""

import json
import os
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

RATE = 16000


def test_phase_farm_tiny():
    out = cs.phase_farm(batch=3, seconds=0.5, rate=RATE, repeats=1)
    for mode in ("fast", "exact"):
        m = out[mode]
        assert set(m) >= {"timing", "clip0", "clip2", "memory_analysis"}
        assert m["clip0"]["max_abs"] <= cs.TOL_FLOAT
        assert m["memory_analysis"]["output_size_in_bytes"] > 0
    assert out["exact"]["clip2"]["lsb"] <= cs.TOL_LSB_EXACT


def test_phase_external_multichannel_tiny():
    out = cs.phase_external_multichannel(batch=3, seconds=0.5, rate=RATE)
    cfg2 = out["config2_external_eq"]
    assert min(cfg2["true_lens"]) < max(cfg2["true_lens"])  # mixed lengths
    assert out["7.1 (Surround)"]["channels"] == 8
    assert out["5.1.2 (Atmos Light)"]["channels"] == 8


def test_phase_service_tiny():
    out = cs.phase_service(
        seconds=(0.3, 0.35, 0.6, 0.65, 0.9, 0.95, 0.4, 0.45), rate=RATE,
        max_wait_ms=300,
    )
    assert len(out["jobs"]) == len(cs.SERVICE_JOBS)
    assert sum(out["batch_sizes"]) == len(cs.SERVICE_JOBS)
    assert {j["format"] for j in out["jobs"]} == {"wav", "flac"}
    assert out["oracle_job"]["lsb"] <= cs.TOL_LSB_EXACT
    assert all(j["latency_s"] > 0 for j in out["jobs"])


def test_phase_long_form_tiny():
    out = cs.phase_long_form(minutes=0.03, rate=RATE, chunk_seconds=0.5)
    assert out["compared_with"] == "oracle"
    assert out["max_abs"] <= cs.TOL_FLOAT


def test_phase_kernel_checks_tiny():
    out = cs.phase_kernel_checks(seconds=0.5, rate=RATE)
    assert out["pcm16_mismatches"] == 0
    assert out["pair_packed_gain_max_abs"] <= cs.TOL_COMPONENT
    assert out["dynamic_eq_batch_max_abs"] <= cs.TOL_COMPONENT


def test_phase_four_chips_on_virtual_cpu_devices():
    assert len(jax.devices()) >= 4
    out = cs.phase_four_chips(
        jax.devices()[:4], batch=4, seconds=0.5, long_minutes=0.03, rate=RATE
    )
    assert out["devices"] == 4
    assert out["data4"]["max_abs_vs_one_card"] <= cs.TOL_FLOAT
    assert out["block4"]["compared_with"] == "one-card render_streaming"
    assert len(out["peak_bytes_in_use"]) == 4


def test_phase_four_chips_needs_four_devices():
    with pytest.raises(AssertionError, match="needs 4 devices"):
        cs.phase_four_chips(jax.devices()[:2], batch=2, seconds=0.1, rate=RATE)


def test_check_audio_rejects_past_contract():
    ref = np.zeros((100, 2))
    ours = ref.copy()
    ours[3, 1] = 2e-3
    with pytest.raises(AssertionError, match="max-abs"):
        cs.check_audio("x", ours, ref)
    with pytest.raises(AssertionError, match="shape"):
        cs.check_audio("x", ours[:50], ref)


def test_gpu_gate_refuses_cpu():
    with pytest.raises(SystemExit, match="needs a GPU"):
        cs.check_device(jax.devices())


def test_gpu_gate_counts_cards():
    gpus = [SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")]
    cs.check_device(gpus, chips=1)
    with pytest.raises(SystemExit, match="--chips 4"):
        cs.check_device(gpus, chips=4)


def test_main_on_cpu_exits_nonzero_without_result(capsys):
    with pytest.raises(SystemExit) as exc:
        cs.main([])
    assert exc.value.code not in (0, None)
    assert '"ok": true' not in capsys.readouterr().out


def test_final_line_contract_shape():
    devs = [SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")] * 4
    line = cs.final_line(devs)
    assert "\n" not in line
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4},
    }


def test_run_phases_runs_every_phase_and_reports_failures(capsys):
    calls = []

    def bad():
        calls.append("bad")
        raise AssertionError("over the limit")

    def good():
        calls.append("good")
        return {"x": 1}

    failed = cs.run_phases([("bad", bad), ("good", good)])
    assert failed == ["bad"] and calls == ["bad", "good"]
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert [(l["phase"], l["ok"]) for l in lines] == [("bad", False), ("good", True)]


@pytest.mark.gpu
def test_kernel_checks_at_render_width_on_gpu(gpu_devices):
    """The component checks compiled for the card at a render's width."""
    out = cs.phase_kernel_checks(seconds=60.0, rate=48000)
    assert out["pcm16_mismatches"] == 0
