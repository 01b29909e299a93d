"""The port's GPipe (``repro_torch.distributed.pipeline``) against the
sequential loop, computed here in JAX and in the port, and against the
reference's own ``pipeline_apply`` (``tests/test_pipeline.py``'s case).

One 4-rank ``gloo`` launch (``test_torch_sharding.run_ranks``) builds three
meshes over the same ranks, a ``("pipe",)`` mesh of 4 (4 stages), a
``("data", "pipe")`` mesh of (2, 2) (2 stages, each pipe group's peers
found through its group) and one of (4, 1) (1 stage, no point-to-point
op), and runs the reference test's case on each: M = 8 microbatches of
2 x 16, one ``tanh(x @ w_s)`` layer a stage, forward and the gradients of w
and x. The reference's ``pipeline_apply`` runs meanwhile in one subprocess
on 4 fake JAX devices, on the same inputs."""
import os
import subprocess
import sys
import textwrap
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from repro.distributed import pipeline as jpipeline
from repro.launch.mesh import make_compat_mesh as jax_compat_mesh
from repro_torch.distributed import pipeline
from test_torch_package import needs_no_card
from test_torch_sharding import ROOT, RANKS_TIMEOUT, run_ranks
from torch.distributed.tensor import Replicate, Shard
from torch_threads import shared_cores  # noqa: F401  (autouse: the worker's share of the cores)

M, MB, D = 8, 2, 16
# name: (shape, dim names); the stages are the "pipe" dim's size
MESHES = {"pipe4": ((4,), ("pipe",)), "data2_pipe2": ((2, 2), ("data", "pipe")),
          "data4_pipe1": ((4, 1), ("data", "pipe"))}
WORLD = 4


def stages(tag: str) -> int:
    shape, axes = MESHES[tag]
    return shape[axes.index("pipe")]


def inputs() -> dict:
    """The reference test's case from a seed: w (4, D, D), one layer a
    stage (a mesh of S stages takes the first S), and x (M, MB, D)."""
    rng = np.random.default_rng(0)
    return {"w": (rng.standard_normal((4, D, D)) * 0.3).astype(np.float32),
            "x": rng.standard_normal((M, MB, D)).astype(np.float32)}


# the reference's pipeline_apply on 4 fake devices, as tests/test_pipeline.py
# runs it: y and the gradients of (y ** 2).sum() in w and x
REFERENCE = textwrap.dedent("""
    import sys
    import jax, jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.distributed.pipeline import pipeline_apply
    from repro.launch.mesh import make_compat_mesh

    data = np.load(sys.argv[1])
    mesh = make_compat_mesh((4,), ("pipe",))
    w = jax.device_put(jnp.asarray(data["w"]), NamedSharding(mesh, P("pipe")))
    x = jnp.asarray(data["x"])

    def block(w_s, xb):
        return jnp.tanh(xb @ w_s)

    def piped(w_, x_):
        return pipeline_apply(block, w_, x_, mesh=mesh, axis="pipe")

    y = jax.jit(piped)(w, x)
    gw, gx = jax.jit(jax.grad(lambda w_, x_: (piped(w_, x_) ** 2).sum(), argnums=(0, 1)))(w, x)
    np.savez(sys.argv[2], y=np.asarray(y), gw=np.asarray(jax.device_get(gw)), gx=np.asarray(gx))
""")

# every rank: the three meshes over the default group's 4 ranks; on each, the
# case through pipeline_apply, its output and gradients (full) and the
# point-to-point ops this rank posted, saved to a file of the rank's own
PIPELINES = """
    import numpy as np
    from repro_torch.convert import params_from_numpy
    from repro_torch.distributed import pipeline
    from repro_torch.launch.mesh import make_compat_mesh
    from repro_torch.sharding.partition import device_put

    data, out_path = np.load(args[0]), args[1]
    posted = []
    batch_isend_irecv = dist.batch_isend_irecv

    def counted(ops):
        posted.extend(ops)
        return batch_isend_irecv(ops)

    dist.batch_isend_irecv = counted

    def block(p, xb):
        return torch.tanh(xb @ p["w"])

    arrays = {}
    for tag, (shape, axes) in MESHES.items():
        mesh = make_compat_mesh(shape, axes, device="cpu")
        n = shape[axes.index("pipe")]
        stage = params_from_numpy({"w": data["w"][:n]}, device="cpu")
        params = {k: v.requires_grad_() for k, v in
                  device_put(stage, {"w": pipeline.stage_params_sharding(mesh)}).items()}
        x = torch.tensor(data["x"]).requires_grad_()
        posted.clear()
        y = pipeline.pipeline_apply(block, params, x, mesh=mesh, axis="pipe")
        (y ** 2).sum().backward()
        arrays[f"{tag}/y"] = y.detach().numpy()
        arrays[f"{tag}/gw"] = params["w"].grad.full_tensor().numpy()
        arrays[f"{tag}/gx"] = x.grad.numpy()
        arrays[f"{tag}/p2p_ops"] = np.array(len(posted))
        arrays[f"{tag}/stage"] = np.array(mesh.get_local_rank("pipe"))
        arrays[f"{tag}/w_placements"] = np.array([str(p) for p in params["w"].placements])
    np.savez(f"{out_path}.rank{rank}.npz", **arrays)
    dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def piped(tmp_path_factory):
    """Each rank's arrays (``{tag}/{y,gw,gx,p2p_ops,stage,w_placements}``)
    and the reference's ``pipeline_apply`` at S = 4 (``y``, ``gw``,
    ``gx``)."""
    tmp = tmp_path_factory.mktemp("pipeline")
    data, out, ref = tmp / "inputs.npz", tmp / "out", tmp / "reference.npz"
    np.savez(data, **inputs())
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    reference = subprocess.Popen([sys.executable, "-c", REFERENCE, str(data), str(ref)],
                                 cwd=ROOT, env=env, stdin=subprocess.DEVNULL,
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        run_ranks(tmp, WORLD, f"MESHES = {MESHES!r}\n" + textwrap.dedent(PIPELINES), data, out)
        _, err = reference.communicate(timeout=RANKS_TIMEOUT)
    finally:
        if reference.poll() is None:
            reference.kill()
            reference.wait()
    assert reference.returncode == 0, err[-4000:]
    ranks = []
    for r in range(WORLD):
        with np.load(f"{out}.rank{r}.npz") as arrays:
            ranks.append({k: arrays[k] for k in arrays.files})
    with np.load(ref) as arrays:
        return ranks, {k: arrays[k] for k in arrays.files}


@pytest.fixture(scope="module")
def sequential():
    """The unpipelined loop at each stage count, ``{S: {"jax": (y, gw, gx),
    "port": (y, gw, gx)}}``: S layers in turn over all microbatches, the
    gradients those of (y ** 2).sum()."""
    data, out = inputs(), {}
    for n in sorted({stages(tag) for tag in MESHES}):
        def loss(w_, x_):
            y = x_
            for s in range(n):
                y = jnp.tanh(y @ w_[s])
            return (y ** 2).sum(), y

        (_, y), (gw, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
            jnp.asarray(data["w"][:n]), jnp.asarray(data["x"]))
        w = torch.tensor(data["w"][:n], requires_grad=True)
        x = torch.tensor(data["x"], requires_grad=True)
        yt = x
        for s in range(n):
            yt = torch.tanh(yt @ w[s])
        (yt ** 2).sum().backward()
        out[n] = {"jax": tuple(np.asarray(a) for a in (y, gw, gx)),
                  "port": (yt.detach().numpy(), w.grad.numpy(), x.grad.numpy())}
    return out


@pytest.mark.parametrize("tag", sorted(MESHES))
def test_pipeline_matches_the_sequential_loop(piped, sequential, tag):
    """On every rank: y within 1e-5 and the gradients of w and x within 1e-4
    of the sequential loop in JAX and in the port (the reference test's
    limits), y and x's gradient replicated over the pipe axis."""
    ranks, _ = piped
    for side in ("jax", "port"):
        y, gw, gx = sequential[stages(tag)][side]
        for r, got in enumerate(ranks):
            np.testing.assert_allclose(got[f"{tag}/y"], y, atol=1e-5, rtol=0,
                                       err_msg=f"{side}, rank {r}")
            np.testing.assert_allclose(got[f"{tag}/gw"], gw, atol=1e-4, rtol=0,
                                       err_msg=f"{side}, rank {r}")
            np.testing.assert_allclose(got[f"{tag}/gx"], gx, atol=1e-4, rtol=0,
                                       err_msg=f"{side}, rank {r}")


def test_four_stages_match_the_references_pipeline_apply(piped):
    """S = 4, M = 8: every rank's y within 1e-5 and the gradients within 1e-4
    of the reference's ``pipeline_apply`` on 4 fake JAX devices."""
    ranks, ref = piped
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["pipe4/y"], ref["y"], atol=1e-5, rtol=0, err_msg=r)
        np.testing.assert_allclose(got["pipe4/gw"], ref["gw"], atol=1e-4, rtol=0, err_msg=r)
        np.testing.assert_allclose(got["pipe4/gx"], ref["gx"], atol=1e-4, rtol=0, err_msg=r)


@pytest.mark.parametrize("tag", sorted(MESHES))
def test_point_to_point_ops_and_placements(piped, tag):
    """Each pipe group's stages are 0..S-1; each of the M (S - 1) stage
    boundaries a microbatch crosses costs a send and a receive forward and
    again backward (no wrap-around edge), so a group posts 4 M (S - 1)
    ops and one stage none; w is stored ``Shard(0)`` over "pipe",
    ``Replicate()`` over "data"."""
    ranks, _ = piped
    shape, axes = MESHES[tag]
    n = stages(tag)
    groups = {}
    for r, got in enumerate(ranks):
        # ranks are laid out row-major on the mesh: a pipe group is a row
        groups.setdefault(r // n, []).append((int(got[f"{tag}/stage"]),
                                              int(got[f"{tag}/p2p_ops"])))
        want = [str(Shard(0)) if a == "pipe" else str(Replicate()) for a in axes]
        assert list(got[f"{tag}/w_placements"]) == want
    for group in groups.values():
        assert sorted(stage for stage, _ in group) == list(range(n))
        assert sum(ops for _, ops in group) == 4 * M * (n - 1)
    if n == 1:
        assert all(int(got[f"{tag}/p2p_ops"]) == 0 for got in ranks)


@pytest.mark.parametrize("n_stages, n_microbatches", [(1, 8), (4, 12), (4, 8), (2, 8), (8, 1)])
def test_bubble_fraction_equals_the_references(n_stages, n_microbatches):
    assert pipeline.bubble_fraction(n_stages, n_microbatches) == jpipeline.bubble_fraction(
        n_stages, n_microbatches)


def test_microbatch_count_mismatch_raises():
    """The reference asserts ``x.shape[0] == n_microbatches``; the port
    raises before it touches the mesh."""
    x = torch.zeros(M, MB, D)
    with pytest.raises(ValueError, match="microbatches"):
        pipeline.pipeline_apply(lambda p, xb: xb, {}, x, mesh=None, n_microbatches=M // 2)


@pytest.mark.parametrize("tag", sorted(MESHES))
def test_stage_params_sharding_placements(tag):
    """The spec shards the leading stage dim over the axis, as the
    reference's ``P(axis)``; as placements, ``Shard(0)`` on that mesh dim and
    ``Replicate()`` on any other."""
    shape, axes = MESHES[tag]
    mesh = types.SimpleNamespace(mesh_dim_names=axes, shape=shape, ndim=len(shape))
    sh = pipeline.stage_params_sharding(mesh)
    ref = jpipeline.stage_params_sharding(jax_compat_mesh((1,), ("pipe",)))
    assert ref.spec == PartitionSpec("pipe") and sh.spec == ("pipe",)
    assert sh.placements == tuple(Shard(0) if a == "pipe" else Replicate() for a in axes)


def test_make_compat_mesh_asks_for_the_card():
    """Without a card, the default device raises before any process group
    is started, as ``make_host_mesh`` does."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_compat_mesh

    needs_no_card()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_compat_mesh((1,), ("pipe",))
    assert not dist.is_initialized()
