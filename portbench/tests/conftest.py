"""Settings of the benchmark's own tests.

``card``: a test that runs the benchmark on a CUDA card. It is skipped
without one; whether there is one is decided inside the ``card`` fixture,
never while a module is imported. Run them on the card with
``python3 -m pytest portbench/tests/test_portbench_card.py -q -m card``
(the other files compare with the JAX package, which the card's machine
does not run)."""

import json
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: runs the benchmark on a CUDA card (skipped "
        "without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark runs on the card only")


@pytest.fixture
def tiny_configs(tmp_path, monkeypatch):
    """The configurations at a size the CPU's plain kernels run in a
    second or two, in place of ``portbench/configs``."""
    from portbench import loop

    cfg_dir = tmp_path / "configs"
    cfg_dir.mkdir()
    for path in (ROOT / "portbench" / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg["rows"] = 2048 + 8 * cfg["ndims"]
        if "series_rows" in cfg:
            cfg["rows"], cfg["series_rows"] = 2048, 512
        (cfg_dir / path.name).write_text(json.dumps(cfg))
    monkeypatch.setattr(loop, "CONFIG_DIR", cfg_dir)
    return cfg_dir
