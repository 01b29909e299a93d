"""The port's checkpoint and fault-tolerance modules on the CPU: ports of
``tests/test_infra.py``'s checkpoint, watchdog and elastic-restart cases,
and the port's own: snapshot isolation under in-place updates, bf16 and
int32 leaves to the bit, the manifest codec byte for byte against
``msgpack``, ``LanguageModel.load_params``' refusals, and the runner's
handling of a failed segment."""
import os
import threading
import time
import weakref

import msgpack
import numpy as np
import pytest
import torch

import repro_torch.configs as tconfigs
from repro_torch.checkpoint import _msgpack, ckpt
from repro_torch.checkpoint.ckpt import AsyncCheckpointer, latest_step, restore, save
from repro_torch.ft import ElasticRunner, RunState, StepWatchdog, StragglerStats
from repro_torch.models import LanguageModel
from repro_torch.train.optim import tree_map

CPU = torch.device("cpu")


# --- ports of tests/test_infra.py: checkpoint ------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": {"w": torch.arange(6.0).reshape(2, 3)},
            "b": torch.ones(4, dtype=torch.bfloat16)}
    save(str(tmp_path), 7, tree, extra={"note": "hi"})
    step, out, extra = restore(str(tmp_path), device="cpu")
    assert step == 7 and extra["note"] == "hi"
    np.testing.assert_array_equal(out["a"]["w"].numpy(), np.arange(6.0).reshape(2, 3))
    assert out["b"].dtype == torch.bfloat16
    assert torch.equal(out["b"], tree["b"])


def test_checkpoint_latest_pointer_atomic(tmp_path):
    tree = {"w": torch.zeros(3)}
    save(str(tmp_path), 1, tree)
    save(str(tmp_path), 2, tree)
    assert latest_step(str(tmp_path)) == 2
    # partially-written garbage directory must not confuse restore
    os.makedirs(tmp_path / "step_000000099")
    assert latest_step(str(tmp_path)) == 2
    assert restore(str(tmp_path), device="cpu")[0] == 2
    assert not [d for d in os.listdir(tmp_path) if d.startswith(".")]


def test_checkpoint_async_and_gc(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save_async(s, {"w": torch.full((2,), float(s))})
    ck.wait()
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert len(steps) == 2 and steps[-1] == "step_000000004"
    _, out, _ = restore(str(tmp_path), device="cpu")
    np.testing.assert_array_equal(out["w"].numpy(), [4.0, 4.0])
    assert [r["step"] for r in ck.saves] == [1, 2, 3, 4]
    assert all(r["bytes"] == 8 and r["write_s"] is not None for r in ck.saves)


@pytest.mark.parametrize("device", ["cpu", CPU])
def test_checkpoint_restore_onto_a_given_device(tmp_path, device):
    """The port's counterpart of the reshard case: leaves come back on the
    device asked for, whatever held them at save time."""
    save(str(tmp_path), 1, {"w": torch.arange(8.0), "s": {"n": torch.tensor(3)}})
    _, out, _ = restore(str(tmp_path), device=device)
    assert out["w"].device == CPU and out["s"]["n"].device == CPU
    np.testing.assert_array_equal(out["w"].numpy(), np.arange(8.0))
    assert int(out["s"]["n"]) == 3


# --- ports of tests/test_infra.py: fault tolerance --------------------------------

def test_watchdog_detects_hang():
    wd = StepWatchdog(deadline_s=0.2, poll_s=0.05)
    with wd:
        wd.step_started()
        time.sleep(0.5)
        with pytest.raises(TimeoutError):
            wd.check()


def test_watchdog_clean_steps_no_hang():
    wd = StepWatchdog(deadline_s=0.5, poll_s=0.05)
    with wd:
        for _ in range(5):
            wd.step_started()
            time.sleep(0.02)
            wd.step_finished()
            wd.check()
    assert not wd._thread.is_alive()


def test_straggler_detection():
    st = StragglerStats(threshold=2.0, streak_to_flag=3)
    flagged = False
    for _ in range(10):
        flagged |= st.observe(1.0)
    assert not flagged
    for _ in range(3):
        flagged |= st.observe(5.0)
    assert flagged


def test_elastic_restart_resumes_from_checkpoint(tmp_path):
    """A segment that crashes mid-run restarts and completes from the last
    checkpoint, preserving step monotonicity."""
    crashes = {"n": 0}

    def mesh_factory():
        return CPU

    def build_state(mesh, restore_step):
        if restore_step is not None:
            _, tree, extra = restore(str(tmp_path), device=mesh)
            return RunState(params=tree["params"], opt_state=tree["opt"],
                            step=int(extra["step"]))
        return RunState(params={"w": torch.zeros(2)}, opt_state={"n": 0}, step=0)

    def train_segment(runner, st, max_steps):
        while st.step < max_steps:
            st.params = {"w": st.params["w"] + 1.0}
            st.step += 1
            runner.maybe_save(st)
            if st.step == 5 and crashes["n"] == 0:
                crashes["n"] += 1
                runner.maybe_save(st, force=True)
                runner.ckpt.wait()
                raise RuntimeError("injected node failure")
        runner.maybe_save(st, force=True)
        runner.ckpt.wait()
        return st

    runner = ElasticRunner(str(tmp_path), mesh_factory, build_state, train_segment,
                           save_every=2)
    st = runner.run(10)
    assert st.step == 10 and st.restarts == 1
    assert crashes["n"] == 1
    # params reflect resumed progress (>= 10 increments minus lost tail)
    assert float(st.params["w"][0]) >= 9.0


# --- the port's own cases ----------------------------------------------------------

def test_snapshot_is_a_copy_the_next_step_cannot_overwrite(tmp_path, monkeypatch):
    """``save_async``, then an in-place update of the saved parameter and its
    optimizer state, as ``apply_updates`` makes one, before the background
    write reads them: the checkpoint holds the values from before the update.
    (A snapshot by ``.cpu()`` shares a CPU tensor's memory and fails this.)"""
    started, release = threading.Event(), threading.Event()
    write = ckpt._write

    def held_write(*args):
        started.set()
        assert release.wait(10)
        return write(*args)

    monkeypatch.setattr(ckpt, "_write", held_write)
    params = {"w": torch.arange(4, dtype=torch.bfloat16)}
    opt = {"step": torch.tensor(1, dtype=torch.int32), "mu": {"w": torch.ones(4)}}
    before = {"w": params["w"].clone(), "mu": opt["mu"]["w"].clone()}
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save_async(1, {"params": params, "opt": opt})
    assert started.wait(10)
    with torch.no_grad():
        params["w"].add_(100.0)
        opt["mu"]["w"].mul_(-3.0)
        opt["step"].add_(1)
    release.set()
    ck.wait()
    _, out, _ = restore(str(tmp_path), device="cpu")
    assert torch.equal(out["params"]["w"], before["w"])
    assert torch.equal(out["opt"]["mu"]["w"], before["mu"])
    assert int(out["opt"]["step"]) == 1


BITS_DTYPES = [torch.bfloat16, torch.float16, torch.float32, torch.float64, torch.int8,
               torch.uint8, torch.int32, torch.int64, torch.bool]


@pytest.mark.parametrize("dtype", BITS_DTYPES, ids=str)
def test_leaves_come_back_with_their_bits_and_dtype(tmp_path, dtype):
    """Random bit patterns (NaN payloads, subnormals and -0 among them for
    the floating types), a 0-d int32 like the optimizer's ``step`` and a
    non-contiguous view: the same dtype and the same bits."""
    gen = torch.Generator().manual_seed(3)
    raw = torch.randint(0, 256, (6, 40), dtype=torch.uint8, generator=gen)
    leaf = raw.view(dtype) if dtype != torch.bool else raw % 2 == 1
    tree = {"leaf": leaf, "view": leaf.t(), "step": torch.tensor(7, dtype=torch.int32)}
    save(str(tmp_path), 3, tree)
    _, out, _ = restore(str(tmp_path), device="cpu")
    for k, v in tree.items():
        assert out[k].dtype == v.dtype and out[k].shape == v.shape
        assert np.array_equal(out[k].reshape(-1).view(torch.uint8).numpy(),
                              v.reshape(-1).view(torch.uint8).numpy()), k
    assert out["step"].dim() == 0 and int(out["step"]) == 7


def test_bf16_is_stored_as_uint16_bits_with_its_dtype_in_meta(tmp_path):
    w = torch.tensor([1.0, -2.5, float("inf")], dtype=torch.bfloat16)
    save(str(tmp_path), 1, {"p": {"w": w}, "f": torch.zeros(2)})
    d = tmp_path / "step_000000001"
    manifest = msgpack.unpackb((d / "manifest.msgpack").read_bytes())
    assert manifest["names"] == ["f", "p/w"]
    assert manifest["meta"] == {"p/w": {"dtype": "bfloat16"}}
    with np.load(d / "arrays.npz") as data:
        assert sorted(data.files) == ["f", "p__w"]
        assert data["p__w"].dtype == np.uint16
        np.testing.assert_array_equal(data["p__w"], w.view(torch.int16).numpy().view(np.uint16))


def manifest(n_names: int, name_len: int, extra: dict) -> dict:
    names = [f"layers/{i:06d}/" + "w" * name_len for i in range(n_names)]
    return {"step": 123456, "time": 1760000000.123456,
            "meta": {n: {"dtype": "bfloat16"} for n in names[::3]},
            "extra": extra, "names": names}


MANIFESTS = {
    "empty": {"step": 0, "time": 0.0, "meta": {}, "extra": {}, "names": []},
    "sixteen_names": manifest(16, 4, {"step": 16}),
    "over_64k_of_names": manifest(700, 100, {"step": 1 << 20}),
    "ints": manifest(3, 2, {"neg": [-1, -32, -33, -128, -129, -32768, -32769, -(1 << 31),
                                    -(1 << 31) - 1, -(1 << 63)],
                            "pos": [0, 127, 128, 255, 256, 65535, 65536, (1 << 32) - 1,
                                    1 << 32, (1 << 64) - 1]}),
    "nested_extra": manifest(2, 1, {"a": {"b": {"c": [None, True, False, 1.5, -0.0,
                                                      "é" * 40, "x" * 300, "y" * 70000,
                                                      list(range(20)), (3, 4)]}},
                                    "m": {str(i): i for i in range(17)},
                                    "big": {str(i): -i for i in range(70000)}}),
}


@pytest.mark.parametrize("name", sorted(MANIFESTS))
def test_codec_is_msgpacks_bytes_and_reads_them_back(name):
    obj = MANIFESTS[name]
    data = _msgpack.packb(obj)
    assert data == msgpack.packb(obj)
    want = msgpack.unpackb(data)
    assert _msgpack.unpackb(data) == want
    assert _msgpack.unpackb(msgpack.packb(obj)) == want


@pytest.mark.parametrize("bad", [np.int64(1), b"raw", {1, 2}, 1j, torch.zeros(1)],
                         ids=["numpy_int", "bytes", "set", "complex", "tensor"])
def test_codec_refuses_other_types(bad):
    with pytest.raises(TypeError):
        _msgpack.packb({"extra": {"x": bad}})


def test_codec_refuses_out_of_range_ints_and_bad_data():
    for v in (1 << 64, -(1 << 63) - 1):
        with pytest.raises(OverflowError):
            _msgpack.packb(v)
    with pytest.raises(ValueError, match="subset"):
        _msgpack.unpackb(b"\xc4\x01x")          # bin 8: not in a manifest
    with pytest.raises(ValueError, match="truncated"):
        _msgpack.unpackb(msgpack.packb("abc")[:-1])
    with pytest.raises(ValueError, match="extra data"):
        _msgpack.unpackb(msgpack.packb(1) + b"\x00")


def test_saved_manifest_is_msgpacks_encoding_of_itself(tmp_path):
    tree = {f"p{i:02d}": torch.zeros(1, dtype=torch.bfloat16 if i % 2 else torch.float32)
            for i in range(20)}
    save(str(tmp_path), 5, tree, extra={"step": 5, "note": [1, -2]})
    data = (tmp_path / "step_000000005" / "manifest.msgpack").read_bytes()
    assert msgpack.packb(msgpack.unpackb(data)) == data
    assert _msgpack.unpackb(data) == msgpack.unpackb(data)


SMOKE = "tinyllama-1.1b-smoke"


def smoke_tree(arch=SMOKE):
    model = LanguageModel(tconfigs.get(arch)).init(torch.Generator().manual_seed(0),
                                                   device="cpu")
    return tree_map(lambda p: p.detach(), model.params)


def test_load_params_refuses_a_tree_of_another_shape():
    model = LanguageModel(tconfigs.get(SMOKE))
    tree = smoke_tree()
    model.load_params(tree)                                  # its own: accepted
    missing = {k: v for k, v in tree.items() if k != "ln_f"}
    with pytest.raises(ValueError, match="'ln_f' is missing"):
        model.load_params(missing)
    with pytest.raises(ValueError, match="'zz' is not one of this model's"):
        model.load_params({**tree, "zz": torch.zeros(1)})
    bad = {**tree, "layers": {**tree["layers"],
                              "attn": {**tree["layers"]["attn"], "wq": torch.zeros(3, 4)}}}
    with pytest.raises(ValueError, match=r"'layers\.attn\.wq' has shape \(3, 4\)"):
        model.load_params(bad)
    with pytest.raises(ValueError, match=r"'ln_f\.scale' has a subtree"):
        model.load_params({**tree, "ln_f": {"scale": tree["ln_f"]}})
    with pytest.raises(ValueError, match="'ln_f' is a leaf, expected a subtree"):
        model.load_params({**tree, "ln_f": tree["ln_f"]["scale"]})
    # another architecture's parameters fail at load, not at a product
    with pytest.raises(ValueError, match="parameter"):
        model.load_params(smoke_tree("granite-3-2b-smoke"))


def test_runner_without_a_checkpoint_dir_saves_nothing_and_raises(tmp_path):
    built = []

    def build_state(mesh, restore_step):
        built.append(restore_step)
        return RunState(params={"w": torch.zeros(1)}, opt_state={}, step=0)

    def train_segment(runner, st, max_steps):
        st.step = 1
        runner.maybe_save(st, force=True)
        raise RuntimeError("injected")

    runner = ElasticRunner(None, lambda: CPU, build_state, train_segment)
    with pytest.raises(RuntimeError, match="injected"):
        runner.run(3)
    assert built == [None] and runner.ckpt is None


def test_restart_drops_the_failed_state_and_waits_for_its_save(tmp_path, monkeypatch):
    """The failed segment started a save that is still being written when it
    fails: the restart waits for it and resumes from it, and the failed
    segment's parameters are gone before the next segment is built."""
    write = ckpt._write

    def slow_write(*args):
        time.sleep(0.3)
        return write(*args)

    monkeypatch.setattr(ckpt, "_write", slow_write)
    seen = []

    def build_state(mesh, restore_step):
        alive = [ref() is not None for ref in seen]
        if restore_step is None:
            params = {"w": torch.zeros(3)}
            step = 0
        else:
            _, tree, extra = restore(str(tmp_path), device=mesh)
            params, step = tree["params"], int(extra["step"])
        st = RunState(params=params, opt_state={}, step=step)
        st.alive_at_build = alive
        st.restored = restore_step
        seen.append(weakref.ref(params["w"]))
        return st

    def train_segment(runner, st, max_steps):
        while st.step < max_steps:
            st.params["w"].add_(1.0)
            st.step += 1
            runner.maybe_save(st)
            if st.step == 3 and st.restored is None:
                raise RuntimeError("injected before the write of step 2 has committed")
        return st

    runner = ElasticRunner(str(tmp_path), lambda: CPU, build_state, train_segment,
                           save_every=2)
    st = runner.run(4)
    assert st.restarts == 1 and st.restored == 2 and st.step == 4
    assert st.alive_at_build == [False]
    np.testing.assert_array_equal(st.params["w"].numpy(), [4.0] * 3)


# --- the fleet autoscaling policy ---------------------------------------------------


def fleet_loop(scaler, n: int, arrivals: int, max_batch: int, ticks: int) -> list:
    """A fleet under a stationary load: each tick ``arrivals`` requests join
    the queue, each instance runs up to ``max_batch`` of them, and the
    policy sizes the fleet from the queue and the running work. The
    observations and the fleet size after each tick."""
    queue, seen = 0, []
    for _ in range(ticks):
        queue += arrivals
        running = min(queue, n * max_batch)
        queue -= running
        obs = (n, queue, running, max_batch)
        n = scaler.decide(*obs)
        seen.append((obs, n))
    return seen


@pytest.mark.parametrize("kw, start, arrivals", [
    ({}, 1, 50), ({}, 20, 50), ({"max_instances": 6}, 1, 40),
    ({"min_instances": 2, "high_batches": 1.0, "low_batches": 0.5, "down_util": 0.9}, 12, 30)])
def test_autoscaler_decides_as_the_reference(kw, start, arrivals):
    """The port's policy makes the reference's decision at every tick of a
    closed loop, which settles on a fleet that keeps up with the load, and
    on seeded random observations given as ints and as numpy scalars."""
    from repro.ft.elastic import QueueDepthAutoscaler as Reference

    from repro_torch.ft import QueueDepthAutoscaler

    max_batch = 8
    seen = fleet_loop(QueueDepthAutoscaler(**kw), start, arrivals, max_batch, 200)
    ref = Reference(**kw)
    assert [n for _, n in seen] == [ref.decide(*obs) for obs, _ in seen]
    final = seen[-1][1]
    assert {n for _, n in seen[-50:]} == {final}
    assert final * max_batch >= arrivals
    assert kw.get("min_instances", 1) <= final <= kw.get("max_instances", 64)

    rng = np.random.default_rng(0)
    port, ref = QueueDepthAutoscaler(**kw), Reference(**kw)
    for i in range(500):
        obs = (rng.integers(1, 12), rng.integers(0, 300), rng.integers(0, 100),
               rng.integers(1, 16))
        obs = obs if i % 2 else tuple(int(x) for x in obs)
        assert port.decide(*obs) == ref.decide(*obs)
