"""scripts/kernel_versions.py's arguments, where there is no card: an
unknown kernel group, an empty ``--only`` or no tree prints the usage and
returns 2; a valid call returns 1 (no CUDA device) before it builds
anything. The timings themselves run on the card only."""

import importlib.util
from pathlib import Path

import pytest
import torch

torch.set_num_threads(2)

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "kernel_versions.py"


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location("kernel_versions", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize(
    "argv", [[], ["--only"], ["--only", "k9", "tree"], ["--only", "k5b"]],
    ids=["no-tree", "no-group", "unknown-group", "group-no-tree"],
)
def test_kernel_versions_usage(script, argv, capsys):
    assert script.main(argv) == 2
    assert "kernel_versions.py [--only GROUP,...] TREE" in capsys.readouterr().err


def test_kernel_versions_needs_a_card(script, tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the script would time it")
    assert script.main(["--only", "k5b", str(tmp_path)]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert not (tmp_path / "tpucap_torch").exists()
