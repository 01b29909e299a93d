"""The MLA training slice on the CPU: K2a/K2b's plain versions at v head dim
Dv != q/k head dim D (the smoke model's (24, 16) and deepseek-v2-236b's
(192, 128)) against the reference's Pallas backward (interpret mode) and
``jax.vjp`` of its oracle; the autograd Function at Dv != D against
``jax.vjp`` of the reference's chunked ``sdpa``; K2's refusal of a pair it
has no instance for; one ``make_train_step`` of ``deepseek-v2-236b-smoke``
past the S <= 256 shortcut against the reference's jitted step; and the
training entry point on the CPU. The CUDA instances at (192, 128) are held
against the same plain versions on the card by ``chip_smoke.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.kernels import ref
from repro.kernels.flash_attention_bwd import flash_attention_bwd_pallas
from repro.models import LanguageModel as JaxLM
from repro.models import attention as jattn
from repro.train import OptimConfig as JaxOptimConfig
from repro.train import init_opt_state as jax_init_opt_state
from repro.train import make_train_step as jax_make_train_step
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import flash_attention_bwd as tbwd
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import HEAD_DIMS
from repro_torch.launch import train as ttrain
from repro_torch.models import LanguageModel
from repro_torch.train import OptimConfig, init_opt_state, make_train_step
from repro_torch.train.optim import tree_leaves
from torch_threads import shared_cores  # noqa: F401  (autouse: the worker's share of the cores)

SMOKE = "deepseek-v2-236b-smoke"
# the tolerances of tests/test_kernels.py:14; bf16 carries ~3 decimal digits
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# (q/k head dim, v head dim): the smoke model's MLA widths (head_dim 16 +
# rope 8, v 16) and deepseek-v2-236b's (128 + 64, 128)
PAIRS = [(24, 16), (192, 128)]


def both(arr, dtype):
    """The same values (rounded to ``dtype`` once, by JAX) on both sides."""
    j = jnp.asarray(arr).astype(JDT[dtype])
    return j, torch.tensor(np.asarray(j.astype(jnp.float32))).to(TDT[dtype])


def close(got, want, tol, msg=""):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol, err_msg=msg)


def backward_inputs(seed, b, s, h, kvh, d, dv, causal, dtype):
    """q, k, v, dout (rounded to ``dtype``), the forward's out (the oracle's,
    in ``dtype``) and lse (fp32), each as (jax, torch)."""
    rng = np.random.default_rng(seed)
    q, k, v, dout = (both(rng.standard_normal(shape, np.float32), dtype)
                     for shape in ((b, s, h, d), (b, s, kvh, d), (b, s, kvh, dv), (b, s, h, dv)))
    scale = d ** -0.5
    g = h // kvh
    qf, kf = (x[0].astype(jnp.float32) for x in (q, k))
    sc = jnp.einsum("bqhgd,bkhd->bhgqk", qf.reshape(b, s, kvh, g, d), kf) * scale
    if causal:
        sc = jnp.where(jnp.tril(jnp.ones((s, s), bool))[None, None, None], sc, -1e30)
    lse = jax.nn.logsumexp(sc, axis=-1).transpose(0, 3, 1, 2).reshape(b, s, h)
    out = ref.flash_attention_ref(q[0], k[0], v[0], causal=causal, scale=scale)
    return q, k, v, dout, both(np.asarray(out.astype(jnp.float32)), dtype), \
        (lse, torch.tensor(np.asarray(lse)))


@pytest.mark.parametrize("d,dv", PAIRS)
@pytest.mark.parametrize("kvh", [2, 1])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_backward_at_dv_vs_pallas_and_vjp(d, dv, kvh, causal, dtype):
    """B=1, S=128, H=2 (G=1 at KVH=2, G=2 at KVH=1), scale D^-0.5: dq, dk and
    dv of the plain versions (whole, and K2a's and K2b's apart, which agree
    with it to the bit) against the Pallas backward on 64 x 64 blocks and
    ``jax.vjp`` of ``flash_attention_ref``, in the inputs' dtype."""
    b, s, h = 1, 128, 2
    q, k, v, dout, out, lse = backward_inputs(5, b, s, h, kvh, d, dv, causal, dtype)
    args = [x[1] for x in (q, k, v, out, lse, dout)]
    got = tbwd.flash_attention_bwd_plain(*args, causal=causal)
    assert torch.equal(tbwd.flash_attention_bwd_dq_plain(*args, causal=causal), got[0])
    dk, dv_ = tbwd.flash_attention_bwd_dkv_plain(*args, causal=causal)
    assert torch.equal(dk, got[1]) and torch.equal(dv_, got[2])
    assert [tuple(x.shape) for x in got] == [(b, s, h, d), (b, s, kvh, d), (b, s, kvh, dv)]
    assert all(x.dtype == TDT[dtype] for x in got)
    pallas = flash_attention_bwd_pallas(*(x[0] for x in (q, k, v, out, lse, dout)),
                                        causal=causal, block_q=64, block_kv=64, interpret=True)
    _, vjp = jax.vjp(lambda q_, k_, v_: ref.flash_attention_ref(q_, k_, v_, causal=causal,
                                                                scale=d ** -0.5),
                     q[0], k[0], v[0])
    autodiff = vjp(dout[0])
    tol = TOL[dtype]
    for name, x, p, a in zip(("dq", "dk", "dv"), got, pallas, autodiff):
        close(x, p.astype(jnp.float32), tol, f"{name} vs Pallas")
        close(x, a.astype(jnp.float32), tol, f"{name} vs jax.vjp")


@pytest.mark.parametrize("d,dv", PAIRS)
@pytest.mark.parametrize("causal", [True, False])
def test_autograd_function_at_dv_vs_chunked_sdpa(d, dv, causal):
    """The autograd Function (the plain forward and backward on the CPU) at
    S=320, past the S <= 256 shortcut, against ``jax.vjp`` of the reference's
    ``sdpa(impl="chunked")`` (its custom VJP), fp32, MLA's scale D^-0.5, on
    the same cotangent."""
    b, s, h = 2, 320, 2
    rng = np.random.default_rng(6)
    q, k, v, dout = (rng.standard_normal(shape, np.float32)
                     for shape in ((b, s, h, d), (b, s, h, d), (b, s, h, dv), (b, s, h, dv)))
    scale = d ** -0.5
    want_out, vjp = jax.vjp(lambda q_, k_, v_: jattn.sdpa(q_, k_, v_, causal=causal,
                                                          impl="chunked", scale=scale), q, k, v)
    want = vjp(jnp.asarray(dout))
    qt, kt, vt = (torch.tensor(x).requires_grad_() for x in (q, k, v))
    out = ops.flash_attention_op(qt, kt, vt, causal=causal, scale=scale)
    assert out.shape == (b, s, h, dv)
    close(out, want_out, TOL["float32"], "out")
    got = torch.autograd.grad(out, (qt, kt, vt), torch.tensor(dout))
    for name, x, w in zip(("dq", "dk", "dv"), got, want):
        assert x.shape == w.shape
        close(x, w, TOL["float32"], name)


def test_k2_wrappers_name_their_head_dim_pairs():
    """K2's plan and launch arguments take K1's (D, Dv) pairs, among them
    deepseek-v2-236b's (head_dim + rope_head_dim, v_head_dim) = (192, 128),
    and refuse any other naming the pairs; the wrappers launch nothing for
    CPU tensors (the plain versions take any pair)."""
    cfg = tconfigs.get("deepseek-v2-236b")
    pair = (cfg.head_dim + cfg.rope_head_dim, cfg.v_head_dim)
    assert pair == (192, 128) and pair in HEAD_DIMS
    assert set(tbwd.DQ_KEYS) == set(tbwd.DKV_Q_TILES) == set(HEAD_DIMS)
    # its training shape: one KV head a query head, so K2b's cluster is 1
    plan = tbwd.bwd_plan(4, 1024, 1024, cfg.n_heads, cfg.n_heads, 192, torch.bfloat16, True,
                         dv=128)
    assert plan.dq_tiles == (64, 32) and plan.dkv_tiles == (16, 64)
    assert (plan.cluster, plan.heads_per_block) == (1, 1)
    assert plan.dq_grid == plan.dkv_grid == (4 * cfg.n_heads, 16, 1)
    for d, dv in ((24, 16), (192, 192), (128, 64)):
        with pytest.raises(ValueError, match=r"\(192, 128\)"):
            tbwd.bwd_plan(1, 64, 64, 2, 2, d, torch.bfloat16, True, dv=dv)
        q, k, v = torch.zeros(1, 8, 2, d), torch.zeros(1, 8, 2, d), torch.zeros(1, 8, 2, dv)
        with pytest.raises(ValueError, match=r"\(192, 128\)"):
            tbwd._launch_args(q, k, v, True, None)
    before = (tbwd.flash_attention_bwd_dq.launches, tbwd.flash_attention_bwd_dkv.launches)
    q, k = torch.zeros(1, 64, 2, 192, dtype=torch.bfloat16), torch.zeros(1, 64, 2, 192,
                                                                         dtype=torch.bfloat16)
    v, dout = torch.zeros(1, 64, 2, 128, dtype=torch.bfloat16), torch.zeros(1, 64, 2, 128,
                                                                            dtype=torch.bfloat16)
    lse = torch.zeros(1, 64, 2)
    for wrapper in (tbwd.flash_attention_bwd_dq, tbwd.flash_attention_bwd_dkv):
        with pytest.raises(ValueError, match="CUDA tensors"):
            wrapper(q, k, v, dout, lse, lse)
        with pytest.raises(ValueError, match=r"\(B,Sq,H,Dv\)"):
            wrapper(q, k, v, q, lse, lse)
    assert (tbwd.flash_attention_bwd_dq.launches,
            tbwd.flash_attention_bwd_dkv.launches) == before


# ---- the model's training step ---------------------------------------------------------

def to_numpy_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), tree)


def test_one_train_step_past_the_shortcut_equals_reference():
    """One step of make_train_step on deepseek-v2-236b-smoke at S=512 (past
    ``sdpa``'s S <= 256 shortcut: the port's autograd Function at q/k head
    dim 24, v head dim 16, once a layer; the reference's chunked custom VJP)
    against the reference's jitted step, fp32, on the same batch: the loss,
    the gradient norm and every gradient leaf within 1e-5, and every
    parameter after the update (AdamW with fp32 master weights) within 1e-5
    wherever Adam's first step is well-conditioned.

    That step moves a parameter by lr * g' / (|g'| + eps), g' the clipped
    gradient: where |g'| is near eps (1e-8) a summation-order difference of
    1e-9 in g' moves the parameter by up to 2 lr, whichever side is right. So
    elements with |g'| < 100 eps (under 2 % of them) are held to that 2 lr,
    the rest to 1e-5. One step only: past it Adam's normalisation
    magnifies such differences further."""
    cj, ct = jconfigs.get(SMOKE), tconfigs.get(SMOKE)
    jm = JaxLM(cj, impl="chunked")
    jparams = jm.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    tm = LanguageModel(ct, impl="kernel")
    tm.load_params(params_from_numpy(to_numpy_tree(jparams), torch.float32, "cpu"))
    toks = np.random.default_rng(8).integers(0, ct.vocab_size, (2, 512)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    opt_cfg = OptimConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    jcfg = JaxOptimConfig(**opt_cfg.__dict__)
    jbatch = jax.tree.map(jnp.asarray, batch)
    want_g = jax.tree.leaves(jax.grad(jm.loss)(jparams, jbatch))
    jstep = jax.jit(jax_make_train_step(jm, jcfg))
    want_p, _, want_m = jstep(jparams, jax_init_opt_state(jparams, jcfg), jbatch,
                              jax.random.PRNGKey(0))
    tbatch = {k: torch.tensor(v) for k, v in batch.items()}
    calls = []
    apply = ops.FlashAttentionFn.apply

    def counting(*args):
        calls.append(args[0].shape)
        return apply(*args)

    try:
        ops.FlashAttentionFn.apply = counting
        got_g = torch.autograd.grad(tm.loss(tbatch), tree_leaves(tm.params))
        _, _, got_m = make_train_step(tm, opt_cfg)(tm.params, init_opt_state(tm.params, opt_cfg),
                                                   tbatch)
    finally:
        ops.FlashAttentionFn.apply = apply
    assert calls == [(2, 512, ct.n_heads, ct.head_dim + ct.rope_head_dim)] * ct.n_layers * 2
    close(got_m["loss"], want_m["loss"], 1e-5, "loss")
    close(got_m["grad_norm"], want_m["grad_norm"], 1e-5, "grad_norm")
    for g, w in zip(got_g, want_g):
        close(g, w, 1e-5)
    clip = min(1.0, opt_cfg.grad_clip / float(want_m["grad_norm"]))
    lr = float(want_m["lr"])
    ill = 0
    for p, w, g in zip(tree_leaves(tm.params), jax.tree.leaves(want_p), want_g):
        err = np.abs(p.detach().numpy() - np.asarray(w))
        near_eps = np.abs(np.asarray(g)) * clip < 100 * opt_cfg.eps
        ill += int(near_eps.sum())
        assert (err[~near_eps] <= 1e-5 + 1e-5 * np.abs(np.asarray(w))[~near_eps]).all()
        assert (err[near_eps] <= 2 * lr + 1e-5).all()
    # 5,076 of the 316,736 elements here: the 1e-5 check covers the rest
    assert ill < 0.02 * sum(p.numel() for p in tree_leaves(tm.params))


def test_train_main_runs_mla_on_the_cpu(capsys):
    """The entry point for deepseek-v2-236b-smoke at S=320, past the
    shortcut: MLA's gradient through the autograd Function (the plain
    versions on the CPU), losses finite."""
    st = ttrain.main(["--arch", SMOKE, "--steps", "2", "--global-batch", "2",
                      "--seq-len", "320", "--log-every", "1", "--device", "cpu"])
    losses = st.final_losses
    assert st.step == 2 and st.restarts == 0
    assert len(losses) == 2 and all(np.isfinite(losses))
    out = capsys.readouterr().out
    assert sum(line.startswith("step ") for line in out.splitlines()) == 2
    assert "on cpu" in out
