"""The port's training path end to end on the CPU: the data stream against
the reference's, a port of ``tests/test_system.py``'s loss-drop test, and the
single-GPU trainer's entry point with ``--device cpu``."""
import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipeline
from repro_torch.data.pipeline import DataConfig, DataLoader, _batch_at, host_batch_slice
from repro_torch.launch import train as train_launch
from repro_torch.models import LanguageModel
from repro_torch.train import OptimConfig, init_opt_state, make_train_step
import repro_torch.configs as tconfigs


@pytest.mark.parametrize("kind", ["synthetic_lm", "zipf_lm"])
@pytest.mark.parametrize("step,rows", [(0, slice(0, 4)), (7, slice(2, 4))])
def test_batches_bit_equal_reference(kind, step, rows):
    cfg = DataConfig(vocab_size=1000, seq_len=33, global_batch=4, seed=5, kind=kind)
    jcfg = jpipeline.DataConfig(**cfg.__dict__)
    got, want = _batch_at(cfg, step, rows), jpipeline._batch_at(jcfg, step, rows)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(got["labels"][:, :-1], got["tokens"][:, 1:])


def test_loader_yields_the_stream_in_order_from_any_step():
    cfg = DataConfig(vocab_size=50, seq_len=8, global_batch=4, seed=1)
    assert host_batch_slice(cfg, 1, 2) == slice(2, 4)
    loader = DataLoader(cfg, start_step=3, process_index=1, process_count=2)
    try:
        for want_step in (3, 4, 5):
            step, batch = next(loader)
            assert step == want_step and loader.step == step + 1
            np.testing.assert_array_equal(batch["tokens"],
                                          _batch_at(cfg, step, slice(2, 4))["tokens"])
    finally:
        loader.close()
    assert not loader._thread.is_alive()


def test_training_reduces_loss_learnable_data():
    """A port of tests/test_system.py:32-54: memorising a fixed batch, 40
    steps must reduce the loss by more than 1.0 (granite-3-2b-smoke, bf16)."""
    cfg = tconfigs.get("granite-3-2b").smoke()
    model = LanguageModel(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    opt_cfg = OptimConfig(lr=3e-3, warmup_steps=5, total_steps=100)
    opt = init_opt_state(model.params, opt_cfg)
    step = make_train_step(model, opt_cfg)
    tokens = torch.tensor(np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 32)))
    batch = {"tokens": tokens, "labels": tokens}
    losses = []
    for i in range(40):
        _, opt, metrics = step(model.params, opt, batch, torch.Generator().manual_seed(i))
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 1.0, (losses[0], losses[-1])
    assert int(opt["step"]) == 40


def test_train_step_takes_model_params_only():
    model = LanguageModel(tconfigs.get("tinyllama-1.1b-smoke")).init(
        torch.Generator().manual_seed(0), device="cpu")
    opt_cfg = OptimConfig()
    step = make_train_step(model, opt_cfg)
    with pytest.raises(ValueError, match="model.params"):
        step(dict(model.params), init_opt_state(model.params, opt_cfg), {})


@pytest.mark.parametrize("extra", [[], ["--remat", "dots", "--microbatches", "2"]])
def test_train_main_runs_on_the_cpu(extra, capsys):
    """The entry point past the attention shortcut (S=288 > 256), so the
    kernel path's autograd Function carries the gradient (plain versions on
    the CPU)."""
    losses = train_launch.main(["--arch", "tinyllama-1.1b-smoke", "--steps", "3",
                                "--global-batch", "2", "--seq-len", "288", "--log-every", "1",
                                "--device", "cpu", *extra])
    assert len(losses) == 3 and all(np.isfinite(losses))
    out = capsys.readouterr().out
    logged = [line for line in out.splitlines() if line.startswith("step ")]
    assert len(logged) == 3 and all("gnorm" in line for line in logged)
    assert "on cpu" in out
