"""Serving through a device mesh: ``launch.serve.ServingEngine(mesh=)`` and
``launch.serve --mesh-model``, the decode step on caches in
``cache_shardings``' placements, held against the port's unsharded engine
and the reference's ``LanguageModel.decode_step`` on the same weights.

One 4-rank ``gloo`` launch (``test_torch_sharding.run_ranks``) serves six
mesh/config cases and records what the tests below read; each test process
holds its own side (the unsharded port, the reference) against it:

* granite-3-2b smoke on (1, 4): 2 KV heads do not divide "model", so the
  cache's sequence is sharded over "model" and K3's partial results are
  combined (shards 2 and 3 stay empty, position 4 opens shard 1);
* tinyllama-1.1b smoke on (2, 2): batch over "data", KV heads over "model";
* tinyllama-1.1b smoke at batch 1 on (4, 1): ``shard_seq``, the sequence
  over "data";
* zamba2-1.2b smoke with ``fused_ffn`` on (2, 2): the Mamba-2 states on each
  rank's rows, the shared block's K4 on each rank's F-slice;
* deepseek-v2-236b smoke on (1, 4): MLA's latent cache sequence-sharded,
  the MoE through ``models.moe._moe_on_mesh``;
* qwen3-moe-235b-a22b smoke on (2, 2);
* granite-3-2b smoke on (1, 4) again at ``impl="naive"``: the oracle
  decode on each rank's shards, combined the same way.
"""
import inspect
import json
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.configs as jconfigs
from repro.models import LanguageModel as JaxLM
import repro_torch.configs as tconfigs
from repro_torch.launch import serve as tserve
from repro_torch.models import LanguageModel
from test_torch_sharding import run_ranks

# name: (arch, mesh shape, batch, fused_ffn, impl)
CASES = {
    "granite_1x4_seq_over_model": ("granite-3-2b-smoke", (1, 4), 2, False, "kernel"),
    "tinyllama_2x2_kv_heads_over_model": ("tinyllama-1.1b-smoke", (2, 2), 2, False, "kernel"),
    "tinyllama_4x1_batch1_seq_over_data": ("tinyllama-1.1b-smoke", (4, 1), 1, False, "kernel"),
    "zamba2_2x2_fused_ffn": ("zamba2-1.2b-smoke", (2, 2), 2, True, "kernel"),
    "deepseek_v2_1x4_mla_latent_seq": ("deepseek-v2-236b-smoke", (1, 4), 2, False, "kernel"),
    "qwen3_moe_2x2": ("qwen3-moe-235b-a22b-smoke", (2, 2), 2, False, "kernel"),
    "granite_1x4_seq_over_model_naive": ("granite-3-2b-smoke", (1, 4), 2, False, "naive"),
}
# the cache holds MAX_LEN rows, 4 a shard over 4 ranks; the engine writes
# positions 0 .. PROMPT + STEPS - 2
PROMPT, STEPS, MAX_LEN = 5, 4, 16
# main's own run through --mesh-model 2 on the 4 ranks
MAIN_ARGS = ["--arch", "tinyllama-1.1b-smoke", "--device", "cpu", "--batch", "2",
             "--prompt-len", "4", "--gen", "3", "--max-len", "16"]
SHARED = ("CASES", "PROMPT", "STEPS", "MAX_LEN", "MAIN_ARGS")


def prompts(vocab: int, batch: int) -> np.ndarray:
    return np.random.default_rng([vocab, batch]).integers(0, vocab, (batch, PROMPT)).astype(
        np.int32)


def port_model(arch: str, fused: bool, impl: str = "kernel") -> LanguageModel:
    """The seeded fp32 model every rank builds too."""
    model = LanguageModel(tconfigs.get(arch), impl=impl, fused_ffn=fused)
    return model.init(torch.Generator().manual_seed(0), dtype=torch.float32, device="cpu")


# every rank: each case through ServingEngine(mesh=), the engine's layer view
# written through on a sequence-sharded cache, and launch.serve's main
SERVE_RANKS = """
    import numpy as np
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from repro_torch.launch.serve import ServingEngine, main
    from repro_torch.models.attention import write_cache_row
    from repro_torch.sharding.partition import cache_shardings, param_shardings

    out_path = args[0]
    result, arrays = {}, {}

    def named(placements):
        return [f"Shard({p.dim})" if p.is_shard() else type(p).__name__ for p in placements]

    def leaves(tree, prefix=""):
        for k in sorted(tree.keys()):
            v = tree[k]
            yield from leaves(v, f"{prefix}{k}/") if hasattr(v, "keys") else [(prefix + k, v)]

    for name, (arch, shape, batch, fused, impl) in CASES.items():
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
        model = port_model(arch, fused, impl)
        engine = ServingEngine(model, batch, MAX_LEN, mesh=mesh)
        toks = engine.generate(prompts(model.cfg.vocab_size, batch), STEPS)
        want_cache = cache_shardings(engine.cache, mesh, shard_seq=batch == 1)
        want_params = dict(leaves(param_shardings(model.axes(), model.specs(), mesh, fsdp=True)))
        result[name] = {
            "tokens": toks.tolist(), "tokens_dtype": str(toks.dtype),
            "cache": {k: {"dtensor": isinstance(v, DTensor), "placements": named(v.placements),
                          "want": named(want_cache[k].placements)}
                      for k, v in engine.cache.items()},
            "params": {k: [isinstance(v, DTensor), named(v.placements),
                           named(want_params[k].placements)]
                       for k, v in leaves(model.params)}}
        arrays[f"{name}/logits"] = engine.last_logits.numpy()
        arrays[f"{name}/prefill_logits"] = engine.prefill_logits.numpy()
        for k, v in engine.cache.items():
            arrays[f"{name}/cache/{k}"] = v.full_tensor().numpy()

    # a layer's view of a sequence-sharded stacked cache, written at a
    # position of rank 2's shard: the row reaches the stacked storage
    mesh = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
    stacked = DTensor.from_local(torch.zeros(3, 2, 4, 2, 8), mesh,
                                 cache_shardings({"k": torch.empty(3, 2, 16, 2, 8)},
                                                 mesh)["k"].placements, run_check=False)
    row = torch.arange(2 * 2 * 8, dtype=torch.float32).view(2, 2, 8) + 1
    write_cache_row(stacked[1], 9, row)
    full = stacked.full_tensor()
    result["layer_view"] = {"placements": named(stacked.placements),
                            "row_reads_back": bool(torch.equal(full[1, :, 9], row)),
                            "nothing_else_written": int((full != 0).sum()) == row.numel()}

    # the entry point: --mesh-model 2 over the 4 ranks, a (2, 2) mesh
    result["main"] = main(MAIN_ARGS + ["--mesh-model", "2"]).tolist()
    if rank == 0:
        np.savez(out_path, **arrays)
        with open(out_path + ".json", "w") as f:
            json.dump(result, f)
    dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The 4-rank run's results (a dict by case, ``layer_view``, ``main``)
    and arrays (``{case}/logits``, ``{case}/prefill_logits``,
    ``{case}/cache/{leaf}``)."""
    tmp = tmp_path_factory.mktemp("serve_mesh")
    out = str(tmp / "out.npz")
    shared = "".join(f"{name} = {globals()[name]!r}\n" for name in SHARED)
    source = "".join(inspect.getsource(f) for f in (prompts, port_model))
    imports = ("import numpy as np\nimport repro_torch.configs as tconfigs\n"
               "from repro_torch.models import LanguageModel\n")
    run_ranks(tmp, 4, imports + shared + source + textwrap.dedent(SERVE_RANKS), out)
    with open(out + ".json") as f:
        result = json.load(f)
    with np.load(out) as arrays:
        return result, {k: arrays[k] for k in arrays.files}


def unsharded(arch: str, batch: int, fused: bool, impl: str):
    """The port's engine without a mesh on the same weights and prompts."""
    model = port_model(arch, fused, impl)
    engine = tserve.ServingEngine(model, batch, MAX_LEN)
    toks = engine.generate(prompts(model.cfg.vocab_size, batch), STEPS)
    return model, engine, toks


def reference(arch: str, model: LanguageModel, batch: int):
    """The reference's ``decode_step`` (jitted once, the position traced) on
    the port's weights in fp32: the prompt teacher-forced, then greedy.
    Returns (tokens (B, STEPS), the last step's fp32 logits, the prefill's)."""
    cfg = model.cfg
    jm = JaxLM(jconfigs.get(arch), impl="naive")
    jparams = jax_tree(model.params)
    cache = jm.init_cache(batch, MAX_LEN, dtype=jnp.float32)
    step = jax.jit(jm.decode_step)
    p = prompts(cfg.vocab_size, batch)
    for t in range(PROMPT):
        logits, cache = step(jparams, cache, jnp.asarray(p[:, t:t + 1]), jnp.int32(t))
    prefill = np.asarray(logits[:, -1].astype(jnp.float32))
    toks = [np.argmax(prefill, axis=-1)[:, None]]
    last = prefill
    for i in range(STEPS - 1):
        logits, cache = step(jparams, cache, jnp.asarray(toks[-1], jnp.int32),
                             jnp.int32(PROMPT + i))
        last = np.asarray(logits[:, -1].astype(jnp.float32))
        toks.append(np.argmax(last, axis=-1)[:, None])
    return np.concatenate(toks, axis=1), last, prefill


def jax_tree(params):
    """The port's parameters as a nested dict of jax arrays."""
    return {k: (jax_tree(v) if hasattr(v, "keys") else jnp.asarray(v.detach().numpy()))
            for k, v in params.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_engine_equals_the_unsharded_port(served, case):
    """Greedy tokens identical; the last step's and the prefill's fp32
    logits within 1e-5 of the engine without a mesh."""
    arch, _, batch, fused, impl = CASES[case]
    _, engine, toks = unsharded(arch, batch, fused, impl)
    result, arrays = served
    assert result[case]["tokens_dtype"] == "torch.int32"
    np.testing.assert_array_equal(np.array(result[case]["tokens"]), toks.numpy())
    np.testing.assert_allclose(arrays[f"{case}/logits"], engine.last_logits.numpy(),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(arrays[f"{case}/prefill_logits"], engine.prefill_logits.numpy(),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_engine_equals_the_reference(served, case):
    """Greedy tokens identical to the reference's decode steps on the same
    weights; the last step's and the prefill's logits within 2e-5."""
    arch, _, batch, fused, impl = CASES[case]
    toks, last, prefill = reference(arch, port_model(arch, fused, impl), batch)
    result, arrays = served
    np.testing.assert_array_equal(np.array(result[case]["tokens"]), toks)
    np.testing.assert_allclose(arrays[f"{case}/logits"], last, atol=2e-5, rtol=0)
    np.testing.assert_allclose(arrays[f"{case}/prefill_logits"], prefill, atol=2e-5, rtol=0)


@pytest.mark.parametrize("case", list(CASES))
def test_cache_leaves_lie_in_cache_shardings_and_read_back(served, case):
    """Every cache leaf is a ``DTensor`` in ``cache_shardings``' placements,
    and the whole cache through the mesh equals the unsharded engine's
    within 1e-5: each row written at its position in the shard that holds
    it, the rows past the last position still zero."""
    arch, _, batch, fused, impl = CASES[case]
    _, engine, _ = unsharded(arch, batch, fused, impl)
    result, arrays = served
    for leaf, got in result[case]["cache"].items():
        assert got["dtensor"] and got["placements"] == got["want"], (leaf, got)
    assert sorted(result[case]["cache"]) == sorted(engine.cache)
    last = PROMPT + STEPS - 2
    for leaf, want in engine.cache.items():
        full = arrays[f"{case}/cache/{leaf}"]
        np.testing.assert_allclose(full, want.numpy(), atol=1e-5, rtol=0, err_msg=leaf)
        if leaf not in ("conv", "ssm"):
            assert np.abs(full[:, :, last]).max() > 0 and not full[:, :, last + 1:].any(), leaf


def test_sequence_sharded_cases_shard_the_sequence(served):
    """The cases meant to combine partial results do shard the sequence:
    over "model" for granite's KV cache and deepseek-v2's latent cache, over
    "data" at batch 1; the KV heads over "model" for tinyllama on (2, 2)."""
    result, _ = served
    cache = {case: result[case]["cache"] for case in CASES}
    assert cache["granite_1x4_seq_over_model"]["k"]["placements"] == ["Shard(1)", "Shard(2)"]
    assert cache["deepseek_v2_1x4_mla_latent_seq"]["ckv"]["placements"] == ["Shard(1)",
                                                                             "Shard(2)"]
    assert cache["tinyllama_4x1_batch1_seq_over_data"]["k"]["placements"] == ["Shard(2)",
                                                                               "Replicate"]
    assert cache["tinyllama_2x2_kv_heads_over_model"]["k"]["placements"] == ["Shard(1)",
                                                                              "Shard(3)"]


@pytest.mark.parametrize("case", list(CASES))
def test_engine_places_parameters_as_param_shardings_says(served, case):
    """``ServingEngine(mesh=)`` puts every parameter on the mesh in
    ``param_shardings(fsdp=True)``'s placements."""
    params = served[0][case]["params"]
    assert params and all(is_d and got == want for is_d, got, want in params.values()), params


def test_a_layer_view_writes_through_to_the_stacked_cache(served):
    """``cache["k"][i]`` selects a layer on the replicated dim 0; a row
    written through it at a position of rank 2's sequence shard reaches
    the stacked cache, and nothing else is written."""
    view = served[0]["layer_view"]
    assert view == {"placements": ["Shard(1)", "Shard(2)"], "row_reads_back": True,
                    "nothing_else_written": True}


def test_serve_main_through_a_mesh_equals_it_without(served):
    """``launch.serve --mesh-model 2`` on the 4 ranks ((2, 2)) draws the
    tokens ``launch.serve`` draws without a mesh, which starts no process
    group."""
    toks = tserve.main(MAIN_ARGS)
    assert not dist.is_initialized()
    assert served[0]["main"] == toks.tolist()


def test_mesh_model_refuses_the_audio_family_naming_item_14c():
    """``--mesh-model`` with the encoder-decoder raises before any process
    group starts, naming the item that brings it; so does the engine."""
    with pytest.raises(NotImplementedError, match="item 14c"):
        tserve.main(["--arch", "whisper-base-smoke", "--device", "cpu", "--mesh-model", "1"])
    assert not dist.is_initialized()
    with pytest.raises(NotImplementedError, match="item 14c"):
        tserve.refuse_audio_on_a_mesh(tconfigs.get("whisper-base-smoke"))


def test_serve_without_mesh_model_starts_no_process_group(capsys):
    toks = tserve.main(MAIN_ARGS[:2] + ["--device", "cpu", "--batch", "1", "--prompt-len", "2",
                                        "--gen", "2", "--max-len", "8"])
    assert tuple(toks.shape) == (1, 2)
    assert not dist.is_initialized()
    assert "tok/s" in capsys.readouterr().out
