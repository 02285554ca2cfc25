"""chip_smoke.py: its device check, and its phases rehearsed on the CPU at
tiny shapes (the script itself refuses to run without a GPU)."""

import json
import sys
from pathlib import Path

import jax
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

TINY_FLAGSHIP = dict(G=4, m=8, n=64, h=4, C=2, L=3)
TINY_GENOME = dict(G=8, m=8, n=600, k=4, L=3)


def test_device_check_refuses_cpu(capsys):
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        chip_smoke.main([])
    out = capsys.readouterr().out
    assert '"ok"' not in out and "{" not in out


def test_cli_phases_rehearse_on_cpu(tmp_path, capsys):
    chip_smoke.phase_cli_flagship(tmp_path, TINY_FLAGSHIP)
    chip_smoke.phase_cli_genome(tmp_path, TINY_GENOME)
    out = capsys.readouterr().out
    assert "dense flagship via CLI: mse(train)" in out
    assert "genome recipe via CLI: mse(train)" in out
    assert len(list(tmp_path.glob("*_run/*/predictions.csv"))) == 2


def test_four_phase_on_virtual_devices(capsys):
    """The --four path (sharded sweep vs the same keys on one device) on
    four of the test session's virtual CPU devices."""
    assert len(jax.devices()) >= 4
    chip_smoke.phase_four("cpu", TINY_FLAGSHIP, TINY_GENOME)
    out = capsys.readouterr().out
    assert out.count("sharded == single device") == 2


def test_bench_refuses_cpu():
    import bench

    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        bench.main()
