"""The six examples the port adds beside the reference's, each run once on
the CPU (``--device cpu``) at a small size: what each prints equals what the
reference's script prints at the same arguments, wall-clock fields left
out; the training examples run a few steps at smoke width."""
import json
import os
import pathlib
import re
import subprocess
import sys

import pytest
from torch_threads import shared_cores  # noqa: F401  (autouse: the worker's share of the cores)

ROOT = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"


def run(script, *args, cwd):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, str(EXAMPLES / script), *args], capture_output=True,
                         text=True, env=env, timeout=300, cwd=cwd)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    return out.stdout


def pair(name, args, tmp_path, port_args=()):
    """The port's and the reference's stdout, from the same arguments."""
    got = run(f"{name}_torch.py", *args, "--device", "cpu", *port_args, cwd=tmp_path)
    want = run(f"{name}.py", *args, cwd=tmp_path)
    return got, want


def test_serve_batched(tmp_path):
    got, want = pair("serve_batched", ["--requests", "200"], tmp_path)
    assert got == want
    assert "MISS" in got and " ok" in got


def sized(text):
    """Each config's probed ladder and answer, without the seconds."""
    return re.findall(r"^(\S+)\s+probed \[([^\]]*)\] -> (.*?) \(\d+ probes", text, re.M)


def test_fleet_at_scale(tmp_path):
    args = ["--requests", "2000", "--max-instances", "40", "--trace-out", ""]
    got, want = pair("fleet_at_scale", args, tmp_path)
    assert sized(got) == sized(want)
    assert [name for name, _, _ in sized(got)] == ["GPU-N", "HBM+L3"]
    assert got.splitlines()[0] == want.splitlines()[0]
    # the timeline and windowed table of the sized fleet
    trace = tmp_path / "t.json"
    out = run("fleet_at_scale_torch.py", "--requests", "2000", "--max-instances", "40",
              "--trace-out", str(trace), "--device", "cpu", cwd=tmp_path)
    from repro_torch.obs.timeline import validate_chrome_trace

    assert validate_chrome_trace(json.loads(trace.read_text())) == []
    assert "timeline of the" in out and "thru r/s" in out


def without_seconds(text):
    return [line for line in text.splitlines() if not re.fullmatch(r"\[[\d.]+s total\]", line)]


def test_paged_kv_study(tmp_path):
    got, want = pair("paged_kv_study", ["--max-instances", "16", "--trace-out", ""], tmp_path)
    assert without_seconds(got) == without_seconds(want)
    assert "compression shrinks the SLO fleet" in got


def test_online_repricing(tmp_path):
    got, want = pair("online_repricing", ["--ticks", "6"], tmp_path)
    # the fourth column is each tick's wall-clock repricing time
    strip = [[" ".join(f for i, f in enumerate(line.split()) if i != 3)
              if re.match(r"\s*\d+ ", line) else line for line in text.splitlines()]
             for text in (got, want)]
    assert strip[0] == strip[1]
    assert "stream cache after 6 ticks" in got


def test_quickstart(tmp_path):
    out = run("quickstart_torch.py", "--device", "cpu", "--smoke", "--steps", "3",
              "--ckpt-dir", str(tmp_path / "ckpt"), cwd=tmp_path)
    assert "quickstart model:" in out and "done at step 3" in out
    loss = float(re.search(r"final loss ([\d.]+)", out).group(1))
    assert 0 < loss < 10
    assert (tmp_path / "ckpt" / "step_000000003").is_dir()


def test_fault_tolerance_demo(tmp_path):
    out = run("fault_tolerance_demo_torch.py", "--device", "cpu",
              "--ckpt-dir", str(tmp_path / "ckpt"), cwd=tmp_path)
    assert "[demo] restored checkpoint at step 10" in out
    assert "[demo] completed at step 25 after 1 injected failure(s)" in out
    # steps 11 and 12 ran twice: before the failure and after the restore
    steps = [int(s) for s in re.findall(r"^step\s+(\d+) loss", out, re.M)]
    assert steps == list(range(1, 13)) + list(range(11, 26))
    losses = re.findall(r"^step\s+11 loss\s+(\S+)", out, re.M)
    assert len(losses) == 2 and losses[0] == losses[1]


@pytest.mark.parametrize("name", ["serve_batched", "fleet_at_scale", "paged_kv_study",
                                  "online_repricing", "quickstart", "fault_tolerance_demo"])
def test_example_imports_only_the_port(name):
    import ast

    tree = ast.parse((EXAMPLES / f"{name}_torch.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert "repro_torch" in roots and not roots & {"jax", "repro"}
