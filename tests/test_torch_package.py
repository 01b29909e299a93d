"""The port stands alone: it imports neither jax nor the JAX package, it asks
for the card unless told otherwise, and on the CPU no kernel is launched."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch
from torch_threads import shared_cores  # noqa: F401  (autouse: the worker's share of the cores)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
PORT_SOURCES = sorted(PORT.rglob("*.py"))
SOURCES = PORT_SOURCES + [ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "repro", "flax", "optax", "msgpack", "ml_dtypes"}


def imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax_and_no_reference_package(path):
    assert not imported_roots(path) & FORBIDDEN


def test_every_module_is_checked():
    names = {p.relative_to(PORT).as_posix() for p in PORT_SOURCES}
    for needed in ("__init__.py", "convert.py", "configs/base.py", "models/lm.py",
                   "models/attention.py", "models/layers.py", "kernels/build.py",
                   "kernels/ops.py", "kernels/flash_attention.py",
                   "kernels/flash_attention_bwd.py", "kernels/flash_decode.py",
                   "kernels/ssd_scan.py", "kernels/fused_ffn.py", "models/ssm.py",
                   "models/blocks.py", "configs/mamba2_1_3b.py", "configs/zamba2_1_2b.py",
                   "models/moe.py", "configs/qwen3_moe_235b_a22b.py", "configs/internvl2_26b.py",
                   "configs/deepseek_v2_236b.py",
                   "serve/step.py", "launch/serve.py", "train/__init__.py", "train/optim.py",
                   "train/step.py", "data/pipeline.py", "launch/train.py",
                   "checkpoint/_msgpack.py", "checkpoint/ckpt.py", "ft/watchdog.py",
                   "ft/elastic.py", "sharding/__init__.py",
                   "sharding/partition.py", "launch/mesh.py", "core/__init__.py",
                   "core/hw.py", "core/roofline.py", "core/msm.py", "launch/specs.py",
                   "launch/dryrun.py", "core/trace.py", "check/__init__.py",
                   "check/__main__.py", "check/facts.py", "check/rules.py", "check/streams.py",
                   "check/catalog.py", "check/ptxas.py", "check/cli.py",
                   "core/stackdist.py", "core/cachesim.py", "core/copa.py", "core/sweep.py",
                   "core/perfmodel.py", "workloads/__init__.py", "workloads/common.py",
                   "workloads/hpc.py", "workloads/mlperf.py", "workloads/lm.py",
                   "workloads/kernels.py", "workloads/registry.py", "serve/paged.py",
                   "serve/sim.py"):
        assert needed in names
    for cu in ("flash_attention.cu", "flash_attention_bwd.cu", "flash_decode.cu",
               "ssd_scan.cu", "fused_ffn.cu", "mma_tile.cuh"):
        assert (PORT / "csrc" / cu).is_file()


def test_importing_the_port_leaves_jax_out_of_the_process():
    code = ("import sys, importlib, pkgutil, repro_torch\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules\n"
            "       if m.split('.')[0] in ('jax', 'jaxlib', 'repro', 'msgpack', 'ml_dtypes')]\n"
            "assert not bad, bad\n"
            "print('clean', len([m for m in sys.modules if m.startswith('repro_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("clean")


def needs_no_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device; the test is about one that has none")


def test_entry_points_raise_without_a_card():
    needs_no_card()
    import repro_torch
    import repro_torch.configs as configs
    from repro_torch.convert import params_from_numpy
    from repro_torch.convert import opt_state_from_numpy
    import torch.distributed as dist

    from repro_torch.launch import serve, train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import LanguageModel

    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.default_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.resolve_device("cuda")
    assert repro_torch.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "tinyllama-1.1b-smoke"])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "tinyllama-1.1b-smoke", "--device", "cuda"])
    with pytest.raises(RuntimeError, match="CUDA"):
        LanguageModel(configs.get("tinyllama-1.1b-smoke")).init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy({})
    with pytest.raises(RuntimeError, match="CUDA"):
        opt_state_from_numpy({"step": 0, "mu": {}, "nu": {}})
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", "tinyllama-1.1b-smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", "tinyllama-1.1b-smoke", "--steps", "1", "--device", "cuda"])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "zamba2-1.2b-smoke", "--fused-ffn"])
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", "tinyllama-1.1b-smoke", "--steps", "1", "--mesh-model", "1"])
    # the mesh asks for the card before it starts a process group
    with pytest.raises(RuntimeError, match="CUDA"):
        make_host_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_host_mesh(model=1, device="cuda")
    assert not dist.is_initialized()


def test_analytic_entry_points_raise_without_a_card():
    """The sweep's scans run on the card unless the caller asks for the CPU."""
    needs_no_card()
    from repro_torch.core import cachesim, copa, msm, sweep
    from repro_torch.workloads import registry

    names = registry.suite("mlperf.infer.large")
    traces = [registry.scenario(n) for n in names]
    with pytest.raises(RuntimeError, match="CUDA"):
        sweep.SweepEngine(names, configs=copa.TABLE_V).run()
    with pytest.raises(RuntimeError, match="CUDA"):
        sweep.suite_analysis_for(traces)
    with pytest.raises(RuntimeError, match="CUDA"):
        cachesim.build_streams(traces)
    with pytest.raises(RuntimeError, match="CUDA"):
        sweep.serve_cost_grids("resnet", [copa.GPU_N_BASE])
    with pytest.raises(RuntimeError, match="CUDA"):
        sweep.analysis_for(traces[0])
    with pytest.raises(RuntimeError, match="CUDA"):
        msm.analyze(traces[0])
    with pytest.raises(RuntimeError, match="CUDA"):
        sweep.SweepEngine(names, device="cuda").run()
    # asked for, the CPU runs the NumPy scans and keeps nothing on a device
    suite = sweep.suite_analysis_for(traces, device="cpu")
    assert suite.batch.device is None


def test_checkpoint_entry_points_raise_without_a_card(tmp_path):
    """Restoring and training with a checkpoint directory ask for the card
    too, and touch nothing there before they do."""
    needs_no_card()
    from repro_torch.checkpoint.ckpt import restore, save
    from repro_torch.launch import train

    save(str(tmp_path), 1, {"w": torch.zeros(2)})
    with pytest.raises(RuntimeError, match="CUDA"):
        restore(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        restore(str(tmp_path), device="cuda")
    ckpt = tmp_path / "run"
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", "tinyllama-1.1b-smoke", "--steps", "1", "--ckpt-dir", str(ckpt)])
    assert not ckpt.exists()


def test_cpu_tensors_launch_no_kernel_and_wrappers_refuse_them():
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import flash_decode

    before = (flash_attention.launches, flash_decode.launches)
    q = torch.randn(1, 8, 4, 32)
    k = torch.randn(1, 8, 2, 32)
    ops.flash_attention_op(q, k, k, causal=True)
    ops.flash_decode_op(q[:, 0], k, k, 5)
    # the kernel wrappers themselves take CUDA tensors only: no silent plain version
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention(q, k, k, causal=True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_decode(q[:, 0], k, k, 5)
    assert (flash_attention.launches, flash_decode.launches) == before


def test_ssm_and_ffn_kernels_launch_nothing_on_cpu_and_refuse_cpu_tensors():
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_ffn import fused_ffn
    from repro_torch.kernels.ssd_scan import ssd_scan

    before = (ssd_scan.launches, fused_ffn.launches)
    x = torch.randn(1, 70, 2, 16)
    dt = torch.rand(1, 70, 2)
    a = -torch.rand(2)
    bc = torch.randn(1, 70, 8)
    w = torch.randn(16, 24)
    ops.ssd_scan_op(x, dt, a, bc, bc)
    ops.fused_ffn_op(x[0, :, 0], w, w, w.T.contiguous())
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_scan(x, dt, a, bc, bc)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_ffn(x[0, :, 0].contiguous(), w, w, w.T.contiguous())
    # a whole hybrid forward and decode step on the CPU: still no launch
    import repro_torch.configs as configs
    from repro_torch.models import LanguageModel

    model = LanguageModel(configs.get("zamba2-1.2b-smoke"), impl="kernel", fused_ffn=True)
    model.init(torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():
        model.forward({"tokens": torch.zeros((1, 300), dtype=torch.int64)})
        model.decode_step(model.init_cache(1, 4), torch.zeros((1, 1), dtype=torch.int64), 0)
    assert (ssd_scan.launches, fused_ffn.launches) == before


def test_backward_on_cpu_launches_no_kernel_and_its_wrappers_refuse_cpu_tensors():
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention_bwd import (attention_delta, flash_attention_bwd,
                                                         flash_attention_bwd_dkv,
                                                         flash_attention_bwd_dq)

    counters = (flash_attention_bwd_dq, flash_attention_bwd_dkv)
    before = [c.launches for c in counters]
    q = torch.randn(1, 300, 4, 32, requires_grad=True)
    k = torch.randn(1, 300, 2, 32, requires_grad=True)
    out = ops.flash_attention_op(q, k, k, causal=True)
    out.sum().backward()
    assert q.grad is not None and k.grad is not None
    lse = torch.zeros(1, 300, 4)
    x, kk, do = q.detach(), k.detach(), out.detach()
    delta = attention_delta(do, do)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_bwd(x, kk, kk, do, lse, do, causal=True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_bwd_dq(x, kk, kk, do, lse, delta, causal=True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_bwd_dkv(x, kk, kk, do, lse, delta, causal=True)
    assert [c.launches for c in counters] == before


def test_forward_wrappers_refuse_inputs_whose_gradient_they_would_drop():
    """K1, K3, K4 and K5 write through raw pointers: their outputs carry no grad_fn.
    With grad mode on and an input that requires grad they raise, whatever
    the device, before anything else; only the autograd Function calls K1
    there (under its own no-grad forward)."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import flash_decode

    q = torch.randn(1, 8, 4, 32, requires_grad=True)
    k = torch.randn(1, 8, 2, 32)
    with pytest.raises(RuntimeError, match="requires grad"):
        flash_attention(q, k, k, causal=True)
    with pytest.raises(RuntimeError, match="requires grad"):
        flash_decode(q[:, 0], k, k, 5)
    from repro_torch.kernels.fused_ffn import fused_ffn
    from repro_torch.kernels.ssd_scan import ssd_scan
    w = torch.randn(32, 48, requires_grad=True)
    with pytest.raises(RuntimeError, match="requires grad"):
        fused_ffn(q[0, :, 0].detach(), w, w, w.T)
    dt = torch.rand(1, 8, 4)
    with pytest.raises(RuntimeError, match="requires grad"):
        ssd_scan(q, dt, -torch.rand(4), k[:, :, 0], k[:, :, 0])
    with torch.no_grad():               # no gradient to drop: the device check speaks
        with pytest.raises(ValueError, match="CUDA tensors"):
            flash_attention(q, k, k, causal=True)
        with pytest.raises(ValueError, match="CUDA tensors"):
            flash_decode(q[:, 0], k, k, 5)


def test_kernel_build_finds_its_sources_and_raises_without_a_compiler(monkeypatch, tmp_path):
    import shutil

    from repro_torch.kernels import build

    names = [p.name for p in build.sources()]
    assert names == sorted(names)
    assert {"flash_attention.cu", "flash_attention_bwd.cu", "flash_decode.cu", "ssd_scan.cu",
            "fused_ffn.cu"} <= set(names)
    # headers are hashed, not compiled on their own
    assert [p.name for p in build.headers()] == ["mma_tile.cuh"]
    # the library's name follows the sources' content, the headers' and the flags
    digest = build._digest(build.sources())
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-DX",))
    assert build._digest(build.sources()) != digest
    # an edited header changes the name too, so the library is rebuilt
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    before = build._digest(build.sources())
    assert before == build._digest(build.sources())
    header = csrc / "mma_tile.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert build._digest(build.sources()) != before
    if shutil.which("nvcc") is None:
        monkeypatch.setenv("CUDA_HOME", "/nonexistent")
        with pytest.raises(RuntimeError, match="nvcc"):
            build.find_nvcc()


def test_chip_smoke_fails_without_a_card():
    needs_no_card()
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
