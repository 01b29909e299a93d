"""The port's mesh path on a mesh with a "pod" dim, the reference's
multi-pod layout ``("pod", "data", "model")``, against the unsharded port.

A batch lies over ("pod", "data") (``partition.batch_spec``), so every op
that runs on local shards takes its rows over both dims (the rows role of
``partition.role_placements``): the attention (K1/K2's dispatch), the
embedding and the loss (``layers.on_rows``), the MoE's routing and combine,
the Mamba-2 mixers, K4's and K5's dispatch. One 4-rank ``gloo`` launch
(``test_torch_sharding.run_ranks``) on a (2, 1, 2) mesh, fp32, the
parameters in ``param_shardings(fsdp=True)``'s placements and the batch in
``place_batch``'s: the training loss and every gradient of tinyllama smoke
(loss within 1e-6, gradients within 1e-5) and of qwen3-moe smoke (the MoE
on the rows of both dims), zamba2 smoke's prefill logits under
``fused_ffn`` (K4 and K5 on each rank's rows), each against the same
function without a mesh; K5's dispatch on ``DTensor``s, whose outputs
come back with their rows over both dims; and K3's dispatch on a cache in
``cache_shardings``' layout (rows over both dims), read where it lies."""
import inspect
import json
import textwrap

import numpy as np
import pytest
import torch

import repro_torch.configs as tconfigs
from repro_torch.data.pipeline import DataConfig, _batch_at
from repro_torch.models import LanguageModel
from repro_torch.serve.step import make_prefill_step
from repro_torch.sharding.partition import role_placements, rows_split
from repro_torch.train.optim import tree_leaves
from test_torch_sharding import run_ranks
from torch_threads import shared_cores  # noqa: F401  (autouse: the worker's share of the cores)

POD_MESH = (2, 1, 2)
NAMES = ("pod", "data", "model")
BATCH, SEQ = 4, 288                 # S > 256: attention through K1's autograd Function
TRAIN = ("tinyllama-1.1b-smoke", "qwen3-moe-235b-a22b-smoke")
PREFILL = "zamba2-1.2b-smoke"
LOSS_ATOL, GRAD_ATOL, LOGIT_ATOL = 1e-6, 1e-5, 1e-5
SHARED = ("POD_MESH", "NAMES", "BATCH", "SEQ", "TRAIN", "PREFILL")


def port_model(arch: str, fused: bool = False) -> LanguageModel:
    """The seeded fp32 model on the kernel path; every rank builds it too."""
    model = LanguageModel(tconfigs.get(arch), impl="kernel", fused_ffn=fused)
    return model.init(torch.Generator().manual_seed(0), dtype=torch.float32, device="cpu")


def train_batch(cfg) -> dict:
    """The data pipeline's first global batch (tokens, labels, positions)."""
    batch = _batch_at(DataConfig(cfg.vocab_size, SEQ, BATCH, seed=0), 0, slice(0, BATCH))
    return {k: torch.tensor(v) for k, v in batch.items()}


def loss_and_grads(model, batch) -> tuple:
    loss = model.loss(batch)
    return loss, torch.autograd.grad(loss, tree_leaves(model.params))


POD_RANKS = """
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, distribute_tensor
    from repro_torch.kernels import ops
    from repro_torch.sharding.partition import device_put, param_shardings, place_batch

    out_path = args[0]
    mesh = init_device_mesh("cpu", POD_MESH, mesh_dim_names=NAMES)
    result, arrays = {}, {}

    def named(placements):
        return [f"Shard({p.dim})" if p.is_shard() else type(p).__name__ for p in placements]

    def placed(arch, fused=False):
        model = port_model(arch, fused)
        return model.load_params(device_put(model.params, param_shardings(
            model.axes(), model.specs(), mesh, fsdp=True)))

    for arch in TRAIN:
        model = placed(arch)
        batch = {k: place_batch(v, mesh) for k, v in train_batch(model.cfg).items()}
        loss, grads = loss_and_grads(model, batch)
        arrays[f"{arch}/loss"] = np.float64(loss.full_tensor().item())
        arrays.update({f"{arch}/{i}": g.full_tensor().numpy() for i, g in enumerate(grads)})
        result[arch] = {"batch": {k: named(v.placements) for k, v in batch.items()},
                        "grads_on_mesh": all(isinstance(g, DTensor) for g in grads)}

    model = placed(PREFILL, fused=True)
    tokens = train_batch(model.cfg)
    logits = make_prefill_step(model)({k: tokens[k] for k in ("tokens", "positions")})
    arrays[PREFILL] = logits.numpy()

    # K5's dispatch on DTensors, every input replicated: it takes the rows
    # over "pod" and "data" and hands its outputs back so
    g = torch.Generator().manual_seed(5)
    x = torch.randn(BATCH, 70, 2, 16, generator=g)
    dt = torch.rand(BATCH, 70, 2, generator=g) * 0.1 + 1e-3
    a = -torch.rand(2, generator=g) - 0.5
    b_, c_ = torch.randn(BATCH, 70, 8, generator=g), torch.randn(BATCH, 70, 8, generator=g)
    whole = [Replicate()] * 3
    with torch.no_grad():
        y, state = ops.ssd_scan_op(*(distribute_tensor(t, mesh, whole) for t in (x, dt, a, b_, c_)))
    want_y, want_state = ops.ssd_scan_plain(x, dt, a, b_, c_)
    result["ssd"] = {"y": named(y.placements), "state": named(state.placements),
                     "local_rows": y.to_local().shape[0],
                     "y_err": float((y.full_tensor() - want_y).abs().max()),
                     "state_err": float((state.full_tensor() - want_state).abs().max())}
    # K3's dispatch on a cache whose rows lie over "pod" and "data" and KV
    # heads over "model" (``cache_shardings``' layout): read where it lies
    from torch.distributed.tensor import Shard
    k, v = (torch.randn(BATCH, 40, 2, 16, generator=g) for _ in range(2))
    q = torch.randn(BATCH, 4, 16, generator=g)
    cache = [Shard(0), Shard(0), Shard(2)]
    with torch.no_grad():
        out = ops.flash_decode_op(distribute_tensor(q, mesh, whole),
                                  distribute_tensor(k, mesh, cache),
                                  distribute_tensor(v, mesh, cache), 33)
    result["decode"] = {"out": named(out.placements),
                        "err": float((out.full_tensor() - ops.flash_decode_plain(q, k, v, 33))
                                     .abs().max())}
    if rank == 0:
        np.savez(out_path, **arrays)
        with open(out_path + ".json", "w") as f:
            json.dump(result, f)
    dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def pod_run(tmp_path_factory):
    """The 4-rank run's results and arrays (``{arch}/loss``, ``{arch}/{i}``
    in ``tree_leaves`` order, ``{PREFILL}``: the prefill's logits)."""
    tmp = tmp_path_factory.mktemp("pod")
    out = str(tmp / "out.npz")
    shared = "".join(f"{name} = {globals()[name]!r}\n" for name in SHARED)
    source = "".join(inspect.getsource(f) for f in (port_model, train_batch, loss_and_grads))
    imports = ("import numpy as np\nimport repro_torch.configs as tconfigs\n"
               "from repro_torch.data.pipeline import DataConfig, _batch_at\n"
               "from repro_torch.models import LanguageModel\n"
               "from repro_torch.serve.step import make_prefill_step\n"
               "from repro_torch.train.optim import tree_leaves\n")
    run_ranks(tmp, 4, imports + shared + source + textwrap.dedent(POD_RANKS), out)
    with open(out + ".json") as f:
        result = json.load(f)
    with np.load(out) as arrays:
        return result, {k: arrays[k] for k in arrays.files}


class StandIn:
    """What the rows role reads of a mesh: its dim names and sizes."""

    def __init__(self, shape, names=NAMES):
        self.shape, self.mesh_dim_names = shape, names


def test_the_rows_role_takes_every_batch_dim():
    """The rows role splits over "pod" and "data" where the batch divides
    their product (``fit``'s rule), over neither where it does not; "data"
    alone stays the role of the capacity blocks and FSDP's sums."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    pod = StandIn(POD_MESH)
    assert role_placements(pod, rows=Shard(0)) == [Shard(0), Shard(0), Replicate()]
    assert role_placements(pod, model=Shard(2), rows=Partial()) == [Partial(), Partial(),
                                                                    Shard(2)]
    assert role_placements(pod, data=Shard(1)) == [Replicate(), Shard(1), Replicate()]
    assert rows_split(pod, 4) and rows_split(pod, 2) and not rows_split(pod, 1)
    assert rows_split(StandIn((2, 3, 1)), 6) and not rows_split(StandIn((2, 3, 1)), 3)
    two = StandIn((2, 2), ("data", "model"))
    assert role_placements(two, rows=Shard(0), model=Shard(2)) == [Shard(0), Shard(2)]
    assert rows_split(two, 2) and not rows_split(two, 3)


@pytest.mark.parametrize("arch", TRAIN)
def test_pod_training_loss_and_gradients_equal_the_unsharded(pod_run, arch):
    """One training loss and every gradient through the (2, 1, 2) mesh,
    the batch's rows over ("pod", "data"), against the unsharded port on
    the same weights and batch."""
    result, arrays = pod_run
    assert result[arch]["grads_on_mesh"]
    for placements in result[arch]["batch"].values():
        assert placements == ["Shard(0)", "Shard(0)", "Replicate"]
    loss, grads = loss_and_grads(port_model(arch), train_batch(tconfigs.get(arch)))
    assert abs(float(arrays[f"{arch}/loss"]) - float(loss.detach())) <= LOSS_ATOL
    assert len(grads) == sum(k.startswith(f"{arch}/") for k in arrays) - 1
    for i, g in enumerate(grads):
        np.testing.assert_allclose(arrays[f"{arch}/{i}"], g.numpy(), rtol=0, atol=GRAD_ATOL,
                                   err_msg=f"{arch} gradient {i}")


def test_pod_prefill_with_k4_and_k5_equals_the_unsharded(pod_run):
    """zamba2 smoke's prefill step under ``fused_ffn`` (K4's and K5's
    dispatch on each rank's rows over "pod" and "data", the Mamba-2 mixers
    through ``layers.on_rows``) against the step without a mesh."""
    _, arrays = pod_run
    model = port_model(PREFILL, fused=True)
    batch = train_batch(model.cfg)
    want = make_prefill_step(model)({k: batch[k] for k in ("tokens", "positions")})
    np.testing.assert_allclose(arrays[PREFILL], want.numpy(), rtol=0, atol=LOGIT_ATOL)


def test_ssd_scan_takes_the_rows_of_both_batch_dims(pod_run):
    ssd = pod_run[0]["ssd"]
    assert ssd["y"] == ssd["state"] == ["Shard(0)", "Shard(0)", "Replicate"]
    assert ssd["local_rows"] == BATCH // (POD_MESH[0] * POD_MESH[1])
    assert ssd["y_err"] <= 1e-5 and ssd["state_err"] <= 1e-5


def test_decode_reads_a_cache_whose_rows_lie_over_both_batch_dims(pod_run):
    dec = pod_run[0]["decode"]
    assert dec["out"] == ["Shard(0)", "Shard(0)", "Shard(1)"] and dec["err"] <= 1e-6
