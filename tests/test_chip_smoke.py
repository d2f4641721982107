"""The parts of chip_smoke.py that run without a GPU: the refusal, the
result line, phase failure handling, phase selection and the nvidia-smi
line.  The phases themselves run on the card."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import bench  # noqa: E402
import chip_smoke  # noqa: E402


class FakeDevice:
    platform = "gpu"
    device_kind = "NVIDIA H100 80GB HBM3"


def test_refuses_without_gpu(capsys):
    # the test process's JAX runs on the CPU
    assert chip_smoke.main([]) == 2
    out, err = capsys.readouterr()
    assert out == ""
    assert "needs a GPU" in err


def test_refuses_from_a_bare_directory(tmp_path):
    # chip_smoke.py alone, without the repository: nonzero, no result line
    (tmp_path / "chip_smoke.py").write_text(
        (REPO / "chip_smoke.py").read_text())
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path,
        capture_output=True, text=True, timeout=300,
        env={"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin"},
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_result_line_format():
    line = chip_smoke.result_line([FakeDevice()])
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}')
    assert json.loads(chip_smoke.result_line([FakeDevice()] * 4))[
        "device"]["count"] == 4


def test_failed_phase_exits_nonzero(capsys):
    ran = []

    def ok(ctx):
        ran.append("ok")

    def bad(ctx):
        chip_smoke.check(False, "deliberate")

    def boom(ctx):
        raise RuntimeError("deliberate")

    failed = chip_smoke.run_phases(
        [("a", ok), ("b", bad), ("c", boom), ("d", ok)], {})
    assert failed == ["b", "c"]
    assert ran == ["ok", "ok"]  # a failure does not stop later phases
    assert chip_smoke.finish(failed, [FakeDevice()]) == 1
    out, err = capsys.readouterr()
    assert '"ok"' not in out
    assert "FAILED phases: b, c" in err
    assert chip_smoke.finish([], [FakeDevice()]) == 0
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["ok"] is True


def test_phase_selection():
    one = [name for name, _ in chip_smoke.select_phases(False)]
    four = [name for name, _ in chip_smoke.select_phases(True)]
    assert one[0] == four[0] == "card"
    assert {"bkw_f64", "plain_reference", "drivers", "timings"} <= set(one)
    # --four runs the sharded paths and what they are compared with, only
    assert four[1:] == ["node_sharded", "spatial_sharded", "ds_sharded"]
    assert not set(four[1:]) & set(one)


@pytest.mark.parametrize("text,want", [
    ("NVIDIA H100 80GB HBM3, 700.00 W\n",
     ("NVIDIA H100 80GB HBM3", "700.00 W")),
    ("NVIDIA H100, 500.00 W\nNVIDIA H100, 500.00 W\n",
     ("NVIDIA H100", "500.00 W")),
    ("\n  NVIDIA H100 PCIe , [N/A]  \n", ("NVIDIA H100 PCIe", "[N/A]")),
])
def test_parse_card_line(text, want):
    assert bench.parse_card_line(text) == want


@pytest.mark.parametrize("text", ["", "\n", "no comma here", ", 700 W"])
def test_parse_card_line_rejects(text):
    with pytest.raises(ValueError):
        bench.parse_card_line(text)


def test_bench_refuses_without_gpu():
    with pytest.raises(SystemExit, match="needs a GPU"):
        bench.main()
