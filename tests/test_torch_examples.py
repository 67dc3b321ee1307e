"""The port's counterparts of the paper's two examples, run on the CPU at
their small size (``--device cpu``), their printed verdicts checked as
``tests/test_system.py`` checks the pipeline's: adversarial negative
sampling beats uniform at an equal budget, with the Eq. 5 debias."""
import importlib.util
import re
from pathlib import Path

import pytest

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"


def _load(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _accuracies(out, pattern):
    """{name: test accuracy} from the lines ``pattern`` matches."""
    return {m.group(1): float(m.group(2)) for m in re.finditer(pattern, out, re.M)}


def test_quickstart_torch_on_cpu(capsys):
    _load("quickstart_torch").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "[1] tree fitted" in out and "OK: adversarial" in out
    acc = _accuracies(out, r"^\[3\] (\S+)\s+test acc=([0-9.]+)")
    assert acc["adversarial+debias"] > acc["uniform"] and acc["adversarial+debias"] > 0.3, acc


@pytest.mark.parametrize("heads", [("adversarial_ns", "uniform_ns")])
def test_compare_heads_torch_on_cpu(capsys, heads):
    _load("compare_heads_torch").main(["--device", "cpu", "--steps", "60", "--labels", "256",
                                       "--heads", *heads])
    out = capsys.readouterr().out
    assert "OK: adversarial negative sampling leads" in out
    acc = _accuracies(out, r"^(\w+)\s+[0-9.]+\s+[0-9.]+\s+([0-9.]+)\s+-?[0-9.]+$")
    assert acc["adversarial_ns"] > acc["uniform_ns"] and acc["adversarial_ns"] > 0.3, acc


def test_examples_default_to_the_card():
    """Without ``--device`` the examples ask for the card (and raise on a
    machine without one), never falling back to the CPU."""
    import torch
    for name in ("quickstart_torch", "compare_heads_torch"):
        mod = _load(name)
        if torch.cuda.is_available():
            continue
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mod.main([])
