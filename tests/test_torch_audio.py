"""The encoder-decoder slice: the port's ``audio`` LanguageModel
(whisper-base: a non-causal encoder over stubbed frame embeddings, a decoder
with causal self-attention and cross-attention to the encoder's output)
against the JAX package's, on converted parameters and the same frames and
tokens: specs, forward and loss (fp32 at 1e-5, and bf16 with the
reference's cast of the frames to bf16), the cache, the decode step, the
serving engine and one training step past the S <= 256 shortcut, where the
encoder, the decoder and the cross-attention all reach the port's autograd
Function (the kernels' plain versions on the CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.launch.serve import ServingEngine as JaxEngine
from repro.models import LanguageModel as JaxLM
from repro.models import blocks as jblocks
from repro.models.base import count_params as jax_count_params
from repro.models.layers import embed as jembed
from repro.models.layers import logits_for_tokens as jax_logits_for_tokens
from repro.models.layers import rmsnorm as jrmsnorm
from repro.train import OptimConfig as JaxOptimConfig
from repro.train import init_opt_state as jax_init_opt_state
from repro.train import make_train_step as jax_make_train_step
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import LanguageModel
from repro_torch.models.base import count_params
from repro_torch.serve.step import make_prefill_step
from repro_torch.train import OptimConfig, init_opt_state, make_train_step
from repro_torch.train.optim import tree_leaves

ARCH = "whisper-base"
SMOKE = ARCH + "-smoke"
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def to_numpy_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), tree)


class UnrolledReference(JaxLM):
    """The reference's model with ``_forward_audio`` as the reference writes
    it (``src/repro/models/lm.py:165-193``: the bf16 cast of the frames,
    the reference's own encoder and decoder blocks, norms and embedding),
    its two ``lax.scan`` loops unrolled into Python loops. With fp32
    parameters the reference's own forward raises: its encoder scan's carry
    enters as the bf16 frames and leaves as fp32, where the first block's
    residual adds an fp32 attention output (JAX's promotion). Unrolled, each
    block runs as the reference defines it; with bf16 parameters it agrees
    with the reference's own forward as two bf16 summation orders agree
    (``test_unrolled_reference_is_the_reference``)."""

    def _forward_audio(self, params, batch):
        cfg = self.cfg
        frames = batch["frames"]
        b, s_enc, _ = frames.shape
        enc_pos = jnp.broadcast_to(jnp.arange(s_enc, dtype=jnp.int32), (b, s_enc))
        x = frames.astype(jnp.bfloat16)
        for i in range(cfg.n_encoder_layers):
            p = jax.tree.map(lambda a: a[i], params["enc_layers"])
            x = jblocks.encoder_block(p, cfg, x, enc_pos, impl=self.impl)
        enc_out = jrmsnorm(params["ln_enc"], x, cfg.norm_eps)
        tokens = batch["tokens"]
        dec_pos = jnp.broadcast_to(jnp.arange(tokens.shape[1], dtype=jnp.int32), tokens.shape)
        y = jembed(params["emb"], tokens)
        for i in range(cfg.n_layers):
            p = jax.tree.map(lambda a: a[i], params["layers"])
            y = jblocks.decoder_block(p, cfg, y, enc_out, dec_pos, enc_pos, impl=self.impl)
        return jrmsnorm(params["ln_f"], y, cfg.norm_eps), jnp.zeros((), jnp.float32)


def reference_and_port(impl_j="naive", impl_t="naive", dtype="float32", seed=0, fused=False):
    """The (unrolled) reference model with parameters of ``dtype`` from its
    own init, and the port holding the same values through the converter."""
    jm = UnrolledReference(jconfigs.get(SMOKE), impl=impl_j)
    jparams = jm.init(jax.random.PRNGKey(seed), dtype=JDT[dtype])
    tm = LanguageModel(tconfigs.get(SMOKE), impl=impl_t, fused_ffn=fused)
    tm.load_params(params_from_numpy(to_numpy_tree(jparams), TDT[dtype], "cpu"))
    return jm, jparams, tm


def batch(seed, b, s_dec, s_enc, d=64):
    """Frames (fp32, as numpy), decoder tokens and next-token labels."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 256, (b, s_dec)).astype(np.int32)
    return {"frames": rng.standard_normal((b, s_enc, d), np.float32), "tokens": toks,
            "labels": np.roll(toks, -1, 1)}


def close(got, want, tol, msg=""):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol, err_msg=msg)


class CountingFn:
    """Records the q shape of every ``FlashAttentionFn`` call while open."""

    def __enter__(self):
        self.calls, self.apply = [], ops.FlashAttentionFn.apply

        def counting(*args):
            self.calls.append(tuple(args[0].shape))
            return self.apply(*args)

        ops.FlashAttentionFn.apply = counting
        return self

    def __exit__(self, *exc):
        ops.FlashAttentionFn.apply = self.apply


@pytest.mark.parametrize("smoke", [False, True])
def test_config_and_param_count_equal_reference(smoke):
    """The port's config equals the reference's field for field; the specs
    (encoder and decoder stacks, ``ln_enc``, the cross-attention) count the
    same parameters, within 2 % of the analytic n_params()."""
    name = ARCH + ("-smoke" if smoke else "")
    cj, ct = jconfigs.get(name), tconfigs.get(name)
    assert ct == type(ct)(**{f: getattr(cj, f) for f in ct.__dataclass_fields__})
    assert ct.family == "audio" and ct.n_encoder_layers == (2 if smoke else 6)
    built = count_params(LanguageModel(ct).specs())
    assert built == jax_count_params(JaxLM(cj).specs())
    assert LanguageModel(ct).axes() == JaxLM(cj).axes()
    assert abs(built - ct.n_params()) / ct.n_params() < 0.02
    if not smoke:
        assert built == 83_194_368         # 26,554,880 of them the tied embedding


def test_converter_keeps_keys_and_values():
    _, jparams, tm = reference_and_port()
    flat_j = {jax.tree_util.keystr(k): np.asarray(v)
              for k, v in jax.tree_util.tree_leaves_with_path(jparams)}
    flat_t = {"".join(f"['{s}']" for s in k.split(".")): v.numpy()
              for k, v in tm.params.state_dict().items()}
    assert flat_t.keys() == flat_j.keys()
    for k in flat_j:
        np.testing.assert_array_equal(flat_t[k], flat_j[k], err_msg=k)
    for key in ("['enc_layers']['attn']['wq']", "['layers']['cross']['wk']",
                "['layers']['ln_cross']['scale']", "['ln_enc']['scale']"):
        assert key in flat_t
    assert "['emb']['lm_head']" not in flat_t          # tied


def bf16_agree(got, want):
    """Two bf16 forwards of whisper-base-smoke: within the model tests' bf16
    tolerance (atol 0.25 / rtol 0.05) and a relative norm of 2e-2. The
    reference against itself with its layer scans unrolled (other XLA
    fusions, so other bf16 roundings) is 1.0e-2 apart by that norm."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, atol=0.25, rtol=0.05)
    assert np.linalg.norm(got - want) <= 2e-2 * np.linalg.norm(want)


def test_unrolled_reference_is_the_reference():
    """The oracle of the fp32 tests below: with fp32 parameters the
    reference's own forward raises at its encoder scan; with bf16 parameters
    (where the reference runs) the unrolled one agrees with it."""
    cj = jconfigs.get(SMOKE)
    bt = {k: jnp.asarray(v) for k, v in batch(9, 2, 16, 64).items()}
    own, unrolled = JaxLM(cj), UnrolledReference(cj)
    with pytest.raises(TypeError, match="carry"):
        own.forward(own.init(jax.random.PRNGKey(0), dtype=jnp.float32), bt)
    params = own.init(jax.random.PRNGKey(0))
    h_own, _ = jax.jit(own.forward)(params, bt)
    h_unrolled, _ = jax.jit(unrolled.forward)(params, bt)
    assert h_own.dtype == h_unrolled.dtype == jnp.bfloat16
    bf16_agree(h_unrolled.astype(jnp.float32), h_own.astype(jnp.float32))


@pytest.mark.parametrize("s_dec,s_enc", [(16, 64), (272, 320)])
@pytest.mark.parametrize("impl_t", ["naive", "kernel"])
def test_forward_and_loss_equal_reference(s_dec, s_enc, impl_t):
    """fp32, 1e-5: hidden states, aux (0) and loss; the reference's frames
    go through its bf16 cast, the port's through the same. At 16 tokens and
    64 frames every attention takes the naive shortcut; at 272 tokens
    against 320 frames the encoder, the decoder's self-attention and its
    cross-attention (Sq 272 against Skv 320) are past it, and under
    impl="kernel" each reaches the autograd Function once a layer."""
    cfg = tconfigs.get(SMOKE)
    jm, jparams, tm = reference_and_port("chunked", impl_t)
    bt = batch(1, 2, s_dec, s_enc)
    jb = {k: jnp.asarray(v) for k, v in bt.items()}
    want_h, want_aux = jm.forward(jparams, jb)
    want_loss = jm.loss(jparams, jb)
    tb = {k: torch.tensor(v) for k, v in bt.items()}
    with torch.no_grad(), CountingFn() as fn:
        got_h, aux = tm.forward(tb)
        loss = tm.loss(tb)
    assert got_h.shape == (2, s_dec, cfg.d_model) and got_h.dtype == torch.float32
    assert float(aux) == float(want_aux) == 0.0
    close(got_h, want_h, 1e-5, "hidden")
    close(loss, want_loss, 1e-5, "loss")
    past = impl_t == "kernel" and s_dec > 256
    n = cfg.n_encoder_layers + 2 * cfg.n_layers
    assert len(fn.calls) == (2 * n if past else 0)      # forward, then loss's forward
    if past:
        assert sorted(set(fn.calls)) == [(2, s_dec, cfg.n_heads, cfg.head_dim),
                                         (2, s_enc, cfg.n_heads, cfg.head_dim)]


def test_fp32_frames_are_rounded_as_the_reference_rounds_them():
    """The cast matters: with fp32 parameters, frames that are not
    bf16-valued give the same hidden states as their bf16 rounding (both
    sides cast), and the port follows the reference's promotion: the first
    encoder block's norm in bf16, the stream fp32 after its residual."""
    _, _, tm = reference_and_port()
    bt = batch(2, 1, 8, 32)
    frames = torch.tensor(bt["frames"])
    tokens = torch.tensor(bt["tokens"])
    with torch.no_grad():
        h, _ = tm.forward({"frames": frames, "tokens": tokens})
        h16, _ = tm.forward({"frames": frames.bfloat16().float(), "tokens": tokens})
    assert h.dtype == torch.float32 and torch.equal(h, h16)


def test_bf16_forward_against_reference():
    """bf16 parameters on both sides, the naive shortcut, against the
    reference's own forward (its scans run in bf16): the hidden states as
    ``bf16_agree`` holds them, the loss within 1e-2."""
    cj = jconfigs.get(SMOKE)
    jm = JaxLM(cj)
    jparams = jm.init(jax.random.PRNGKey(0))
    tm = LanguageModel(tconfigs.get(SMOKE), impl="naive")
    tm.load_params(params_from_numpy(to_numpy_tree(jparams), torch.bfloat16, "cpu"))
    bt = batch(3, 2, 16, 64)
    jb = {k: jnp.asarray(v) for k, v in bt.items()}
    want_h, _ = jax.jit(jm.forward)(jparams, jb)
    tb = {k: torch.tensor(v) for k, v in bt.items()}
    with torch.no_grad():
        got_h, _ = tm.forward(tb)
        loss = tm.loss(tb)
    assert got_h.dtype == torch.bfloat16
    bf16_agree(got_h.float().numpy(), want_h.astype(jnp.float32))
    close(loss, jm.loss(jparams, jb), 1e-2, "loss")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_cache_shapes_and_dtypes(dtype):
    """Self-attention caches of max_len rows, cross caches of enc_len rows
    (0 by default), zeros, in the parameters' dtype; the reference's keys and
    shapes."""
    cfg = tconfigs.get(SMOKE)
    model = LanguageModel(cfg).init(torch.Generator().manual_seed(0), dtype=TDT[dtype],
                                    device="cpu")
    jm = JaxLM(jconfigs.get(SMOKE))
    for enc_len in (0, 24):
        cache = model.init_cache(3, 20, enc_len=enc_len)
        want = jm.init_cache(3, 20, enc_len=enc_len)
        assert {k: tuple(v.shape) for k, v in cache.items()} == \
            {k: tuple(v.shape) for k, v in want.items()}
        assert cache["cross_k"].shape == (cfg.n_layers, 3, enc_len, cfg.n_kv_heads, cfg.head_dim)
        assert all(v.dtype == TDT[dtype] and not bool(v.any()) for v in cache.values())
    assert "cross_k" not in LanguageModel(tconfigs.get("tinyllama-1.1b-smoke")).init(
        torch.Generator().manual_seed(0), device="cpu").init_cache(1, 4, enc_len=8)


@pytest.mark.parametrize("enc_len", [0, 24])
@pytest.mark.parametrize("impl_t", ["naive", "kernel"])
def test_decode_logits_and_caches_equal_reference(impl_t, enc_len):
    """10 teacher-forced steps, fp32 caches on both sides, the cross caches
    filled with the same seeded values (enc_len 24; empty at 0): logits and
    every cache within 1e-5. The cross caches are read, never written."""
    jm, jparams, tm = reference_and_port("naive", impl_t)
    b, s = 2, 10
    rng = np.random.default_rng(4)
    toks = rng.integers(0, 256, (b, s)).astype(np.int32)
    jcache = jm.init_cache(b, 16, dtype=jnp.float32, enc_len=enc_len)
    tcache = tm.init_cache(b, 16, enc_len=enc_len)
    for key in ("cross_k", "cross_v"):
        vals = rng.standard_normal(tcache[key].shape, np.float32)
        jcache[key] = jnp.asarray(vals)
        tcache[key].copy_(torch.tensor(vals))
    cross = {k: tcache[k].clone() for k in ("cross_k", "cross_v")}
    for t in range(s):
        want, jcache = jm.decode_step(jparams, jcache, jnp.asarray(toks[:, t:t + 1]),
                                      jnp.int32(t))
        with torch.no_grad():
            got, same = tm.decode_step(tcache, torch.tensor(toks[:, t:t + 1]), t)
        assert same is tcache and got.shape == (b, 1, 256)
        close(got, want, 1e-5, f"logits at step {t}")
    for key in jcache:
        close(tcache[key], jcache[key], 1e-5, key)
    assert all(torch.equal(tcache[k], v) for k, v in cross.items())


@pytest.mark.parametrize("fused", [False, True])
def test_prefill_step_equals_reference_last_logits(fused):
    """``make_prefill_step`` on frames and tokens: the reference's forward's
    last-position logits, fp32, 1e-5; with ``fused_ffn`` every SwiGLU MLP of
    the encoder and the decoder through K4's plain version."""
    jm, jparams, tm = reference_and_port("naive", "kernel", fused=fused)
    bt = batch(5, 2, 12, 40)
    h, _ = jm.forward(jparams, {k: jnp.asarray(bt[k]) for k in ("frames", "tokens")})
    want = jax_logits_for_tokens(jparams["emb"], h[:, -1:])
    got = make_prefill_step(tm)({k: torch.tensor(bt[k]) for k in ("frames", "tokens")})
    assert got.shape == (2, 1, 256)
    close(got, want, 1e-5)


BATCH, PROMPT, STEPS, MAX_LEN, ENC_LEN = 2, 6, 10, 24, 16


@pytest.mark.parametrize("impl_t", ["naive", "kernel"])
def test_engine_greedy_tokens_identical_to_reference(impl_t):
    """fp32, batch 2, prompt 6, 10 greedy steps, enc_len 16 (cross caches
    left as zeros by both engines): the same token ids. The reference engine
    is given an fp32 cache (its default is bf16)."""
    jm, jparams, tm = reference_and_port("naive", impl_t)
    prompts = np.random.default_rng(6).integers(0, 256, (BATCH, PROMPT)).astype(np.int32)
    jeng = JaxEngine(jm, jparams, BATCH, MAX_LEN, enc_len=ENC_LEN)
    jeng.cache = jm.init_cache(BATCH, MAX_LEN, dtype=jnp.float32, enc_len=ENC_LEN)
    want = jeng.generate(prompts, STEPS)
    teng = tserve.ServingEngine(tm, BATCH, MAX_LEN, enc_len=ENC_LEN)
    assert teng.cache["cross_k"].shape[2] == ENC_LEN
    got = teng.generate(prompts, STEPS)
    assert got.shape == (BATCH, STEPS) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_one_train_step_past_the_shortcut_equals_reference():
    """One step of make_train_step on whisper-base-smoke at 272 tokens
    against 320 frames (past ``sdpa``'s S <= 256 shortcut everywhere: the
    port's autograd Function in the encoder, the decoder and the
    cross-attention; the reference's chunked custom VJP), fp32, against the
    reference's jitted step on the same batch: the loss, the gradient norm
    and every gradient leaf within 1e-5, and every parameter after the
    update within 1e-5 wherever Adam's first step is well-conditioned
    (elements whose clipped gradient is under 100 eps are held to 2 lr, as
    ``tests/test_torch_mla_train.py`` holds MLA's)."""
    cfg = tconfigs.get(SMOKE)
    jm, jparams, tm = reference_and_port("chunked", "kernel")
    bt = batch(8, 2, 272, 320)
    opt_cfg = OptimConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    jcfg = JaxOptimConfig(**opt_cfg.__dict__)
    jbatch = jax.tree.map(jnp.asarray, bt)
    want_g = jax.tree.leaves(jax.grad(jm.loss)(jparams, jbatch))
    jstep = jax.jit(jax_make_train_step(jm, jcfg))
    want_p, _, want_m = jstep(jparams, jax_init_opt_state(jparams, jcfg), jbatch,
                              jax.random.PRNGKey(0))
    tbatch = {k: torch.tensor(v) for k, v in bt.items()}
    with CountingFn() as fn:
        got_g = torch.autograd.grad(tm.loss(tbatch), tree_leaves(tm.params))
        _, _, got_m = make_train_step(tm, opt_cfg)(tm.params, init_opt_state(tm.params, opt_cfg),
                                                   tbatch)
    assert len(fn.calls) == 2 * (cfg.n_encoder_layers + 2 * cfg.n_layers)
    close(got_m["loss"], want_m["loss"], 1e-5, "loss")
    close(got_m["grad_norm"], want_m["grad_norm"], 1e-5, "grad_norm")
    for g, w in zip(got_g, want_g):
        assert float(g.abs().sum()) > 0
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
    assert ill < 0.02 * sum(p.numel() for p in tree_leaves(tm.params))


def test_entry_points_on_the_cpu(capsys):
    """``launch.serve`` serves whisper-base-smoke with its cross caches
    (every SwiGLU MLP through K4's plain version under ``--fused-ffn``);
    ``launch.train`` refuses it with the reason: its data pipeline makes no
    frames, as the reference's makes none."""
    toks = tserve.main(["--arch", SMOKE, "--device", "cpu", "--batch", "2", "--prompt-len", "4",
                        "--gen", "3", "--max-len", "8", "--fused-ffn"])
    assert tuple(toks.shape) == (2, 3)
    assert "tok/s" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="frames"):
        ttrain.main(["--arch", SMOKE, "--steps", "1", "--device", "cpu"])
