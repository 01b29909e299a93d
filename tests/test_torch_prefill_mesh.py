"""The prefill step through a device mesh, for every family:
``serve.step.make_prefill_step`` on a model whose parameters lie in
``param_shardings(fsdp=True)``' placements, its batch placed as
``launch/specs`` places a prefill cell's, held against the port's
unsharded step and the reference's forward on the same weights; the
encoder-decoder's loss and gradients through the mesh; and K5
(``kernels.ops.ssd_scan_op``) on ``DTensor``s.

One 4-rank ``gloo`` launch (``test_torch_sharding.run_ranks``) computes
everything the tests below read; each test process holds its own side
against it. The smoke configs run in fp32 at S = 288 (the encoder-decoder
at 320 frames and 272 tokens), past ``sdpa``'s 256-token shortcut, so that
every attention goes through K1's dispatch on each rank's shards (its
plain version on the CPU), and each Mamba-2 mixer through K5's."""
import inspect
import json
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import LanguageModel as JaxLM
from repro.models.layers import logits_for_tokens as jax_logits_for_tokens
import repro_torch.configs as tconfigs
from repro_torch.kernels import ops
from repro_torch.models import LanguageModel
from repro_torch.serve.step import make_prefill_step
from repro_torch.sharding import partition
from repro_torch.train.optim import tree_leaves
from test_torch_audio import UnrolledReference
from test_torch_serve_mesh import jax_tree
from test_torch_sharding import port_mesh, run_ranks
from torch_threads import shared_cores  # noqa: F401  (autouse: the worker's share of the cores)

# name: (arch, mesh shape, fused_ffn)
CASES = {
    "tinyllama_2x2": ("tinyllama-1.1b-smoke", (2, 2), False),
    "granite_1x4_kv_heads_replicated": ("granite-3-2b-smoke", (1, 4), False),
    "internvl2_2x2_patch_embeds": ("internvl2-26b-smoke", (2, 2), False),
    "qwen3_moe_2x2": ("qwen3-moe-235b-a22b-smoke", (2, 2), False),
    "deepseek_v2_1x4_mla": ("deepseek-v2-236b-smoke", (1, 4), False),
    "zamba2_2x2_fused_ffn": ("zamba2-1.2b-smoke", (2, 2), True),
    "mamba2_1x4": ("mamba2-1.3b-smoke", (1, 4), False),
    "whisper_2x2": ("whisper-base-smoke", (2, 2), False),
    "whisper_1x4": ("whisper-base-smoke", (1, 4), False),
}
BATCH, SEQ, PATCHES = 4, 288, 8
AUDIO_FRAMES, AUDIO_TOKENS = 320, 272
# the encoder-decoder's loss and gradients on (2, 2)
GRAD_ARCH, GRAD_SHAPE = "whisper-base-smoke", (2, 2)
# K5 on DTensors: (B, S, H, P, N) on a (2, 2) mesh
SSD_SHAPE, SSD_MESH = (4, 96, 4, 16, 8), (2, 2)
# the reference's forward against the unsharded port, as the model tests
# hold it: 1e-4 (tests/test_torch_models.py, test_torch_hybrid.py,
# test_torch_moe.py, test_torch_vlm.py, test_torch_mla.py), the
# encoder-decoder 1e-5 (tests/test_torch_audio.py)
REF_TOL = {"audio": 1e-5}
REF_TOL_DEFAULT = 1e-4
SHARED = ("CASES", "BATCH", "SEQ", "PATCHES", "AUDIO_FRAMES", "AUDIO_TOKENS", "GRAD_ARCH",
          "GRAD_SHAPE", "SSD_SHAPE", "SSD_MESH")


def port_model(arch: str, fused: bool) -> LanguageModel:
    """The seeded fp32 model, kernel path, every rank builds too."""
    model = LanguageModel(tconfigs.get(arch), impl="kernel", fused_ffn=fused)
    return model.init(torch.Generator().manual_seed(0), dtype=torch.float32, device="cpu")


def prefill_batch(cfg) -> dict:
    """The seeded batch of a prefill (NumPy): tokens (and positions), patch
    embeddings for a vision front end, frames for the encoder-decoder."""
    rng = np.random.default_rng([cfg.vocab_size, cfg.n_layers, len(cfg.name)])
    s = AUDIO_TOKENS if cfg.family == "audio" else SEQ
    out = {"tokens": rng.integers(0, cfg.vocab_size, (BATCH, s)).astype(np.int32)}
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal((BATCH, AUDIO_FRAMES, cfg.d_model), np.float32)
    else:
        out["positions"] = np.broadcast_to(np.arange(s, dtype=np.int32), (BATCH, s)).copy()
    if cfg.frontend == "vision":
        out["patch_embeds"] = rng.standard_normal((BATCH, PATCHES, cfg.d_model), np.float32)
    return out


def ssd_inputs() -> list:
    """K5's seeded inputs: x, dt (> 0), A (< 0), b_, c_ (fp32)."""
    b, s, h, p, n = SSD_SHAPE
    g = torch.Generator().manual_seed(5)
    return [torch.randn(b, s, h, p, generator=g),
            torch.rand(b, s, h, generator=g) * 0.1 + 1e-3,
            -torch.rand(h, generator=g) - 0.5,
            torch.randn(b, s, n, generator=g), torch.randn(b, s, n, generator=g)]


class Counting:
    """Counts, while open, the calls that reach each kernel's dispatch in
    ``kernels.ops``: K1's autograd Function and the plain versions of K4
    and K5 that the CPU runs in the kernels' place."""
    NAMES = ("FlashAttentionFn", "fused_ffn_plain", "ssd_scan_plain")

    def __enter__(self):
        from repro_torch.kernels import ops as ops_

        self.ops, self.counts = ops_, dict.fromkeys(self.NAMES, 0)
        self.saved = (ops_.FlashAttentionFn.apply, ops_.fused_ffn_plain, ops_.ssd_scan_plain)

        def counted(name, fn):
            def call(*args, **kwargs):
                self.counts[name] += 1
                return fn(*args, **kwargs)
            return call

        ops_.FlashAttentionFn.apply = counted("FlashAttentionFn", self.saved[0])
        ops_.fused_ffn_plain = counted("fused_ffn_plain", self.saved[1])
        ops_.ssd_scan_plain = counted("ssd_scan_plain", self.saved[2])
        return self

    def __exit__(self, *exc):
        (self.ops.FlashAttentionFn.apply, self.ops.fused_ffn_plain,
         self.ops.ssd_scan_plain) = self.saved


# every rank: each case's prefill step through its mesh, counted; whisper's
# loss and gradients on (2, 2); K5 on DTensors and its refusal of a gradient
PREFILL_RANKS = """
    import numpy as np
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
    from repro_torch.kernels import ops
    from repro_torch.serve.step import make_prefill_step
    from repro_torch.sharding.partition import device_put, param_shardings, place_batch
    from repro_torch.train.optim import tree_leaves

    out_path = args[0]
    result, arrays = {}, {}

    def named(placements):
        return [f"Shard({p.dim})" if p.is_shard() else type(p).__name__ for p in placements]

    def placed(arch, fused, mesh):
        model = port_model(arch, fused)
        return model.load_params(device_put(model.params, param_shardings(
            model.axes(), model.specs(), mesh, fsdp=True)))

    for name, (arch, shape, fused) in CASES.items():
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
        model = placed(arch, fused, mesh)
        batch = {k: torch.tensor(v) for k, v in prefill_batch(model.cfg).items()}
        with Counting() as c:
            logits = make_prefill_step(model)(batch)
        every = [None] * world
        dist.all_gather_object(every, logits.numpy())
        result[name] = {"type": type(logits).__name__, "dtype": str(logits.dtype),
                        "shape": list(logits.shape), "counts": c.counts,
                        "same_on_every_rank": all(np.array_equal(e, every[0]) for e in every),
                        "batch": {k: named(place_batch(v, mesh).placements)
                                  for k, v in batch.items()}}
        arrays[name] = logits.numpy()

    # the encoder-decoder's loss and gradients: the new boundaries' backward
    mesh = init_device_mesh("cpu", GRAD_SHAPE, mesh_dim_names=("data", "model"))
    model = placed(GRAD_ARCH, False, mesh)
    batch = {k: torch.tensor(v) for k, v in prefill_batch(model.cfg).items()}
    batch["labels"] = torch.roll(batch["tokens"], -1, 1)
    leaves = tree_leaves(model.params)
    loss = model.loss(batch)
    grads = torch.autograd.grad(loss, leaves)
    arrays["grad/loss"] = np.float32(loss.full_tensor().item())
    arrays.update({f"grad/{i}": g.full_tensor().numpy() for i, g in enumerate(grads)})
    result["grad"] = {"dtensors": all(isinstance(g, DTensor) and g.device_mesh == mesh
                                      for g in grads)}

    # K5 on DTensors: x with its rows over "data", the rest replicated (the
    # op redistributes them to its layout)
    mesh = init_device_mesh("cpu", SSD_MESH, mesh_dim_names=("data", "model"))
    x, dt, A, b_, c_ = ssd_inputs()
    rows = [Shard(0), Replicate()]
    whole = [Replicate(), Replicate()]
    dx = distribute_tensor(x, mesh, rows)
    d_rest = [distribute_tensor(t, mesh, whole) for t in (dt, A, b_, c_)]
    with torch.no_grad(), Counting() as c:
        y, state = ops.ssd_scan_op(dx, *d_rest)
    arrays["ssd/y"] = y.full_tensor().numpy()
    arrays["ssd/state"] = state.full_tensor().numpy()
    result["ssd"] = {"y": named(y.placements), "state": named(state.placements),
                     "local_rows": y.to_local().shape[0], "counts": c.counts}
    try:
        ops.ssd_scan_op(distribute_tensor(x, mesh, rows).requires_grad_(), *d_rest)
        result["ssd"]["grad_refused"] = None
    except RuntimeError as e:
        result["ssd"]["grad_refused"] = str(e)

    if rank == 0:
        np.savez(out_path, **arrays)
        with open(out_path + ".json", "w") as f:
            json.dump(result, f)
    dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def prefilled(tmp_path_factory):
    """The 4-rank run's results (a dict by case, ``grad``, ``ssd``) and
    arrays (``{case}``: the last position's logits; ``grad/loss``,
    ``grad/{i}`` in ``tree_leaves`` order; ``ssd/y``, ``ssd/state``)."""
    tmp = tmp_path_factory.mktemp("prefill_mesh")
    out = str(tmp / "out.npz")
    shared = "".join(f"{name} = {globals()[name]!r}\n" for name in SHARED)
    source = "".join(inspect.getsource(f) for f in (port_model, prefill_batch, ssd_inputs,
                                                     Counting))
    imports = ("import numpy as np\nimport repro_torch.configs as tconfigs\n"
               "from repro_torch.models import LanguageModel\n")
    run_ranks(tmp, 4, imports + shared + source + textwrap.dedent(PREFILL_RANKS), out)
    with open(out + ".json") as f:
        result = json.load(f)
    with np.load(out) as arrays:
        return result, {k: arrays[k] for k in arrays.files}


def unsharded(arch: str, fused: bool):
    """The port's prefill step without a mesh on the same weights and
    batch: (model, numpy batch, logits, dispatch counts)."""
    model = port_model(arch, fused)
    bt = prefill_batch(model.cfg)
    with Counting() as c:
        logits = make_prefill_step(model)({k: torch.tensor(v) for k, v in bt.items()})
    return model, bt, logits, c.counts


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_through_the_mesh_equals_the_unsharded_port(prefilled, case):
    """fp32 logits of the last position within 1e-5 of the step without a
    mesh: a plain (B, 1, V) tensor, the same on every rank, and as many
    calls of K1's, K4's and K5's dispatch as without the mesh."""
    arch, _, fused = CASES[case]
    _, _, want, counts = unsharded(arch, fused)
    result, arrays = prefilled
    got = result[case]
    assert got["type"] == "Tensor" and got["dtype"] == "torch.float32"
    assert got["shape"] == list(want.shape) == [BATCH, 1, tconfigs.get(arch).vocab_size]
    assert got["same_on_every_rank"]
    assert got["counts"] == counts, (got["counts"], counts)
    np.testing.assert_allclose(arrays[case], want.numpy(), atol=1e-5, rtol=0)


def named(placements):
    return [f"Shard({p.dim})" if p.is_shard() else type(p).__name__ for p in placements]


def test_prefill_batch_lies_as_launch_specs_places_it(prefilled):
    """Every tensor of each case's batch, as the step places it, lies where
    ``launch/specs.input_specs`` places a prefill cell's batch: rows over
    "data" (``batch_spec``), replicated over "model"."""
    for case, (_, shape, _) in CASES.items():
        want = named(partition.NamedSharding(port_mesh(shape),
                                             partition.batch_spec(port_mesh(shape))).placements)
        got = prefilled[0][case]["batch"]
        assert got and all(p == want for p in got.values()), (case, got, want)


def test_every_kernel_dispatch_is_reached(prefilled):
    """The cases reach each kernel the path holds, once a layer: K1 in
    every attention (whisper's encoder, self- and cross-attention), K5 in
    every Mamba-2 mixer, K4 in every SwiGLU MLP under ``fused_ffn``."""
    counts = {case: prefilled[0][case]["counts"] for case in CASES}
    z, m, w = (tconfigs.get(CASES[c][0]) for c in ("zamba2_2x2_fused_ffn", "mamba2_1x4",
                                                    "whisper_2x2"))
    shared = z.n_layers // z.attn_every
    assert counts["zamba2_2x2_fused_ffn"] == {"FlashAttentionFn": shared,
                                              "fused_ffn_plain": shared,
                                              "ssd_scan_plain": z.n_layers}
    assert counts["mamba2_1x4"] == {"FlashAttentionFn": 0, "fused_ffn_plain": 0,
                                    "ssd_scan_plain": m.n_layers}
    for case in ("whisper_2x2", "whisper_1x4"):
        assert counts[case]["FlashAttentionFn"] == w.n_encoder_layers + 2 * w.n_layers
    assert counts["tinyllama_2x2"]["FlashAttentionFn"] == tconfigs.get(
        "tinyllama-1.1b-smoke").n_layers


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_through_the_mesh_equals_the_reference(prefilled, case):
    """The last position's logits against the reference's forward on the
    same weights and batch (the encoder-decoder's through
    ``test_torch_audio.UnrolledReference``), at the unsharded port's own
    tolerance against it."""
    arch, _, fused = CASES[case]
    model = port_model(arch, fused)
    cfg = model.cfg
    jm = (UnrolledReference if cfg.family == "audio" else JaxLM)(jconfigs.get(arch),
                                                                 impl="naive")
    jparams = jax_tree(model.params)
    bt = prefill_batch(cfg)
    h, _ = jm.forward(jparams, {k: jnp.asarray(v) for k, v in bt.items()})
    want = np.asarray(jax_logits_for_tokens(jparams["emb"], h[:, -1:]))
    tol = REF_TOL.get(cfg.family, REF_TOL_DEFAULT)
    np.testing.assert_allclose(prefilled[1][case], want, atol=tol, rtol=tol)


def test_encoder_decoder_loss_and_gradients_through_the_mesh(prefilled):
    """whisper-base-smoke's loss and every gradient leaf on (2, 2) within
    1e-5 of the unsharded port's, each gradient a ``DTensor`` on the mesh:
    the sequence-parallel boundaries around each encoder and decoder block,
    and inside the decoder block, carry the backward."""
    result, arrays = prefilled
    model = port_model(GRAD_ARCH, False)
    bt = {k: torch.tensor(v) for k, v in prefill_batch(model.cfg).items()}
    bt["labels"] = torch.roll(bt["tokens"], -1, 1)
    leaves = tree_leaves(model.params)
    loss = model.loss(bt)
    grads = torch.autograd.grad(loss, leaves)
    assert result["grad"]["dtensors"]
    np.testing.assert_allclose(arrays["grad/loss"], loss.item(), atol=1e-5, rtol=0)
    for i, g in enumerate(grads):
        assert float(g.abs().sum()) > 0
        np.testing.assert_allclose(arrays[f"grad/{i}"], g.numpy(), atol=1e-5, rtol=0,
                                   err_msg=str(i))


def test_ssd_scan_op_on_dtensors_equals_the_unsharded_op(prefilled):
    """K5's dispatch on ``DTensor``s on (2, 2): y and the final state within
    1e-5 of the op on the whole tensors, both with their rows over "data"
    (each rank scans 2 of the 4 rows), K5's plain version called once a
    rank."""
    result, arrays = prefilled
    with torch.no_grad():
        y, state = ops.ssd_scan_op(*ssd_inputs())
    assert result["ssd"]["y"] == result["ssd"]["state"] == ["Shard(0)", "Replicate"]
    assert result["ssd"]["local_rows"] == SSD_SHAPE[0] // SSD_MESH[0]
    assert result["ssd"]["counts"]["ssd_scan_plain"] == 1
    np.testing.assert_allclose(arrays["ssd/y"], y.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(arrays["ssd/state"], state.numpy(), atol=1e-5, rtol=0)


def test_ssd_scan_op_on_dtensors_refuses_a_gradient(prefilled):
    """Forward only on a mesh too: an input that requires grad raises, as
    it does off the mesh."""
    reason = prefilled[0]["ssd"]["grad_refused"]
    assert reason is not None and "requires grad" in reason
