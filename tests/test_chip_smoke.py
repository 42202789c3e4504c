"""chip_smoke.py off the card: its helpers, its refusal to run without a
GPU, and every phase rehearsed on the CPU backend at a tiny batch (the
four-device phase on four virtual CPU devices)."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs


class _Dev:
    platform = "gpu"
    device_kind = "NVIDIA H100 80GB HBM3"


def test_device_check_refuses_cpu():
    with pytest.raises(cs.SmokeError, match="needs a GPU"):
        cs.require_gpu(jax.devices("cpu"), 1)


def test_device_check_needs_four_for_four_chips():
    with pytest.raises(cs.SmokeError, match="needs 4 GPUs"):
        cs.require_gpu([_Dev()], 4)
    assert len(cs.require_gpu([_Dev()] * 4, 1)) == 1


def test_main_refuses_cpu_device(monkeypatch, capsys):
    """Past the nvidia-smi and gpu-test stages, JAX's CPU device is
    refused before any phase runs and no result line is printed."""
    monkeypatch.setattr(cs, "query_nvidia_smi",
                        lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    monkeypatch.setattr(cs, "run_gpu_tests", lambda: {"result": "pass"})
    monkeypatch.setattr(cs, "run_phase", lambda *a: pytest.fail("phase ran"))
    with pytest.raises(cs.SmokeError, match="needs a GPU"):
        cs.main([])
    assert '"ok": true' not in capsys.readouterr().out


def test_script_without_gpu_exits_nonzero():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "FAILED" in proc.stderr


def test_script_outside_checkout_exits_nonzero(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "checkout" in proc.stderr


def test_result_line_is_exactly_the_contract():
    line = cs.result_line(_Dev(), 1)
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}')


@pytest.mark.parametrize("field", cs.FIELDS)
def test_compare_flags_one_bit(field):
    rng = np.random.default_rng(0)
    want = {"ok": rng.integers(0, 2, 64).astype(bool),
            "data": rng.integers(0, 256, (64, 223), dtype=np.uint8),
            "parity": rng.integers(0, 256, (64, 32), dtype=np.uint8),
            "corrected": rng.integers(0, 17, 64).astype(np.int32)}
    got = {k: v.copy() for k, v in want.items()}
    assert cs.compare_outputs(got, want) == []
    flat = got[field].reshape(-1)
    flat[37] = ~flat[37] if field == "ok" else flat[37] ^ 1
    bad = cs.compare_outputs(got, want)
    assert len(bad) == 1 and bad[0].startswith(field)


def test_compare_flags_dtype_change():
    want = {"corrected": np.zeros(4, np.int32)}
    assert cs.compare_outputs({"corrected": np.zeros(4, np.int64)}, want)


def test_chips_select_phases():
    assert cs.select_phases(4) == ("sharded",)
    one = cs.select_phases(1)
    assert "sharded" not in one and one[0] == "gpu_tests"
    assert set(one[1:]) == set(cs.SIZES)
    with pytest.raises(cs.SmokeError):
        cs.select_phases(2)


def test_parse_nvidia_smi():
    assert cs.parse_nvidia_smi("NVIDIA H100 80GB HBM3, 700.00 W\n") == [
        ("NVIDIA H100 80GB HBM3", "700.00 W")]
    four = "\n".join(["NVIDIA H100 80GB HBM3, 500.00 W"] * 4)
    assert len(cs.parse_nvidia_smi(four)) == 4
    for bad in ("", "no comma here", "name, "):
        with pytest.raises(cs.SmokeError):
            cs.parse_nvidia_smi(bad)


def test_hlo_collectives():
    hlo = """
  %all-gather.1 = s32[8]{0} all-gather(s32[2]{0} %p), dimensions={0}
  %ars = s32[] all-reduce-start(s32[] %x), to_apply=%add
  %ard = s32[] all-reduce-done(s32[] %ars)
  %add.3 = s32[] add(s32[] %a, s32[] %b)
"""
    assert cs.hlo_collectives(hlo) == {"all-gather": 1, "all-reduce": 1}


def test_distinct_positions():
    rng = np.random.default_rng(1)
    pos = cs.distinct_positions(rng, 500, 40, 32)
    assert pos.shape == (500, 32) and pos.min() >= 0 and pos.max() < 40
    assert (np.diff(pos, axis=1) > 0).all()


# Tiny batches: (batch, rows compared with the reference backend).
REHEARSAL = {
    "rs_plain": (1024, 256), "rs_erasure": (512, 128),
    "rs_ext_syndrome": (512, 128), "bch": (2048, 256),
    "ldpc_hard": (2048, 512), "ldpc_soft": (2048, 512),
    "ldpc_qc": (1024, 256), "ldpc_8192": (8, 2),
}


@pytest.mark.parametrize("name", sorted(REHEARSAL))
def test_phase_rehearsal_on_cpu(name):
    cpu = jax.devices("cpu")
    batch, ref_rows = REHEARSAL[name]
    rec = cs.run_phase(name, batch, ref_rows, np.random.default_rng(0),
                       cpu[0], cpu[1])
    assert rec["result"] == "pass" and rec["batch"] == batch
    assert rec["ref_rows_bit_identical"] == ref_rows
    assert set(rec["memory_analysis"]) == {"argument", "output", "temp",
                                           "generated_code"}
    json.dumps(rec)


def test_sharded_rehearsal_on_four_cpu_devices():
    devices = jax.devices("cpu")[:4]
    assert len(devices) == 4
    rep = cs.run_sharded(devices, 1024, 256, np.random.default_rng(0))
    for name in ("rs_plain", "ldpc_hard", "ldpc_decode_step"):
        assert rep[name]["bit_identical_to_one_device"]
        assert isinstance(rep[name]["collectives"], dict)
    data = rep["rs_plain"]["outputs"]["data"]
    assert data["bytes_per_device"] == [1024 * 223] * 4
    assert rep["ldpc_decode_step"]["collectives"].get("all-reduce", 0) >= 1
    json.dumps(rep)
