"""The port's system path on the CPU: a port of ``tests/test_system.py``'s
train -> checkpoint -> restore -> serve test, checkpoints crossing between
the two runtimes both ways (every leaf to the bit, then the same forward
within the fp32 tolerance of ``tests/test_torch_models.py``), and a crashed
run resumed from its checkpoint ending equal, to the bit, to an
uninterrupted one."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.checkpoint import ckpt as jckpt
from repro.launch.train import main as jax_train_main
from repro.models import LanguageModel as JaxLM
from repro_torch.checkpoint import ckpt
from repro_torch.checkpoint.ckpt import restore
from repro_torch.launch import train as ttrain
from repro_torch.launch.serve import ServingEngine
from repro_torch.models import LanguageModel
from repro_torch.train.optim import tree_leaves, tree_map

SMOKE = "tinyllama-1.1b-smoke"
CPU = torch.device("cpu")


def test_train_then_serve_roundtrip(tmp_path):
    """Train a tiny model a few steps past the attention shortcut (S=288),
    checkpoint every 3 steps, restore, serve tokens."""
    d = str(tmp_path / "ck")
    st = ttrain.main(["--arch", SMOKE, "--steps", "6", "--global-batch", "2",
                      "--seq-len", "288", "--ckpt-dir", d, "--save-every", "3",
                      "--log-every", "100", "--device", "cpu"])
    assert st.step == 6 and st.restarts == 0
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "LATEST", "step_000000003", "step_000000006"]
    _, tree, extra = restore(d, device="cpu")
    assert extra["step"] == 6

    cfg = tconfigs.get(SMOKE)
    model = LanguageModel(cfg).load_params(tree["params"])
    engine = ServingEngine(model, batch=2, max_len=24)
    toks = engine.generate(np.ones((2, 4), np.int32), steps=4)
    assert toks.shape == (2, 4)
    assert bool((toks >= 0).all()) and bool((toks < cfg.vocab_size).all())


def leaf_bits(leaf) -> np.ndarray:
    """A leaf's bytes, flat, from either runtime (bf16 by its bits)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().reshape(-1)
        return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().view(np.uint8)
    return np.ascontiguousarray(np.asarray(leaf)).reshape(-1).view(np.uint8)


def dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return np.asarray(leaf).dtype.name


def assert_same_leaves(got: dict, want: dict):
    """Every leaf of the two trees: the same names, dtypes, shapes and bits."""
    flat_got, flat_want = ckpt._flatten(got), jckpt._flatten(want)
    assert list(flat_got) == list(flat_want)
    for name, g in flat_got.items():
        w = flat_want[name]
        assert dtype_name(g) == dtype_name(w), name
        assert tuple(g.shape) == tuple(np.shape(w)), name
        assert np.array_equal(leaf_bits(g), leaf_bits(w)), name


def assert_forwards_agree(port_params: dict, ref_params: dict):
    """The port's forward on one tree and the reference's on the other, both
    in fp32 from the checkpoint's bf16 values: within 1e-4."""
    jm = JaxLM(jconfigs.get(SMOKE), impl="naive")
    tm = LanguageModel(tconfigs.get(SMOKE), impl="naive")
    tm.load_params(tree_map(lambda t: t.float(), port_params))
    jparams = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.float32), ref_params)
    tokens = np.random.default_rng(1).integers(0, tm.cfg.vocab_size, (2, 12)).astype(np.int32)
    want, _ = jm.forward(jparams, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        got, _ = tm.forward({"tokens": torch.tensor(tokens)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


TRAIN_ARGS = ["--arch", SMOKE, "--steps", "2", "--global-batch", "2", "--seq-len", "32",
              "--save-every", "2", "--log-every", "100"]


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    """The reference trainer writes; the port's restore gives every leaf
    (bf16 parameters, fp32 master weights and moments, the int32 step) with
    the bits the reference's own restore gives, and the same forward."""
    d = str(tmp_path / "ref")
    jax_train_main([*TRAIN_ARGS, "--ckpt-dir", d])
    jstep, jtree, jextra = jckpt.restore(d)
    step, tree, extra = restore(d, device="cpu")
    assert step == jstep == 2 and extra == jextra == {"step": 2}
    assert_same_leaves(tree, jtree)
    assert tree["params"]["ln_f"]["scale"].dtype == torch.bfloat16
    assert tree["opt"]["step"].dtype == torch.int32 and int(tree["opt"]["step"]) == 2
    assert_forwards_agree(tree["params"], jtree["params"])


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    """The port's trainer writes; the reference's restore (``msgpack`` and
    ``ml_dtypes``) reads every leaf with the bits of the port's in-memory
    state, and the reference's forward equals the port's."""
    d = str(tmp_path / "port")
    st = ttrain.main([*TRAIN_ARGS, "--ckpt-dir", d, "--device", "cpu"])
    jstep, jtree, jextra = jckpt.restore(d)
    assert jstep == 2 and jextra == {"step": 2}
    assert_same_leaves({"params": st.params, "opt": st.opt_state}, jtree)
    assert jtree["params"]["ln_f"]["scale"].dtype.name == "bfloat16"
    assert np.asarray(jtree["opt"]["step"]).dtype == np.int32
    assert_forwards_agree(st.params, jtree["params"])


def run_trainer(ckpt_dir, fail_after=None, steps=4):
    """``launch.train``'s runner on the CPU past the attention shortcut; with
    ``fail_after``, its segment raises once right after that step, before
    that step's save."""
    args = ttrain.parse_args(["--arch", SMOKE, "--steps", str(steps), "--global-batch", "2",
                              "--seq-len", "288", "--save-every", "2", "--log-every", "100",
                              "--device", "cpu",
                              *(["--ckpt-dir", str(ckpt_dir)] if ckpt_dir else [])])
    runner = ttrain.make_runner(args, CPU)
    save, failed = runner.maybe_save, []

    def maybe_save(st, force=False):
        if st.step == fail_after and not force and not failed:
            failed.append(st.step)
            raise RuntimeError(f"injected failure after step {st.step}")
        save(st, force)

    runner.maybe_save = maybe_save
    return runner.run(steps), failed


def test_crashed_run_resumes_to_the_bits_of_an_uninterrupted_one(tmp_path, capsys):
    whole, _ = run_trainer(None)
    resumed, failed = run_trainer(tmp_path, fail_after=3)
    assert failed == [3] and resumed.restarts == 1 and resumed.step == whole.step == 4
    out = capsys.readouterr().out
    assert "[train] restored step 2" in out and "restart 1/" in out
    # the resumed segment ran steps 2 and 3
    assert resumed.final_losses == whole.final_losses[2:]
    for got, want in zip(tree_leaves(resumed.params), tree_leaves(whole.params)):
        assert torch.equal(got, want)
    for got, want in zip(tree_leaves(resumed.opt_state), tree_leaves(whole.opt_state)):
        assert got.dtype == want.dtype and torch.equal(got, want)
    _, tree, _ = restore(str(tmp_path), device="cpu")
    assert_same_leaves(tree, {"params": tree_map(lambda t: t.detach(), whole.params),
                              "opt": whole.opt_state})
