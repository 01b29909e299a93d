"""The port's training loss and its gradients against the JAX package:
``chunked_cross_entropy`` on its own, then ``LanguageModel.loss`` with every
parameter's gradient against ``jax.value_and_grad`` of the reference's
``LanguageModel.loss``, on converted parameters and identical numpy batches.

The reference trains with ``impl="chunked"`` (its custom-VJP flash
attention); the port's counterpart is ``impl="kernel"`` (K1 forward, K2a/K2b
backward on the card, their plain versions here)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.models import LanguageModel as JaxLM
from repro.models.layers import chunked_cross_entropy as jax_cce
from repro_torch.convert import params_from_numpy
from repro_torch.models import LanguageModel
from repro_torch.models.layers import chunked_cross_entropy
from repro_torch.train.optim import tree_leaves
from torch_threads import shared_cores  # noqa: F401  (autouse: the worker's share of the cores)

SMOKE = "tinyllama-1.1b-smoke"


def to_numpy_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), tree)


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.mark.parametrize("tied", [True, False])
@pytest.mark.parametrize("s,chunk,masked", [(300, 128, False), (300, 128, True),
                                            (256, 512, True), (64, 64, False)])
def test_chunked_cross_entropy_value_and_grads(tied, s, chunk, masked):
    """fp32, 1e-5: S not a multiple of the chunk (padded), a loss mask, tied
    and untied unembedding."""
    rng = np.random.default_rng(0)
    b, d, vocab = 2, 32, 97
    emb = {"embedding": rng.standard_normal((vocab, d), np.float32) * 0.1}
    if not tied:
        emb["lm_head"] = rng.standard_normal((d, vocab), np.float32) * 0.1
    h = rng.standard_normal((b, s, d), np.float32)
    labels = rng.integers(0, vocab, (b, s)).astype(np.int32)
    mask = (rng.random((b, s)) < 0.7).astype(np.float32) if masked else None

    def jloss(p, h_):
        return jax_cce(p, h_, jnp.asarray(labels), chunk=chunk,
                       mask=None if mask is None else jnp.asarray(mask))

    want, (wp, wh) = jax.value_and_grad(jloss, (0, 1))(emb, h)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in emb.items()}
    th = torch.tensor(h, requires_grad=True)
    got = chunked_cross_entropy(tp, th, torch.tensor(labels), chunk=chunk,
                                mask=None if mask is None else torch.tensor(mask))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(wh), atol=1e-5, rtol=1e-5)
    # untied, the input embedding takes no part in the loss: the reference's
    # gradient is zero, the port's is None
    for key in emb:
        g = tp[key].grad
        g = np.zeros_like(emb[key]) if g is None else g.numpy()
        np.testing.assert_allclose(g, np.asarray(wp[key]), atol=1e-5, rtol=1e-5, err_msg=key)


def models(impl_j, impl_t, remat="none", seed=0):
    jm = JaxLM(jconfigs.get(SMOKE), impl=impl_j)
    jparams = jm.init(jax.random.PRNGKey(seed), dtype=jnp.float32)
    tm = LanguageModel(tconfigs.get(SMOKE), impl=impl_t, remat=remat)
    tm.load_params(params_from_numpy(to_numpy_tree(jparams), torch.float32, "cpu"))
    return jm, jparams, tm


def batch_of(seed, b, s, vocab, masked=False):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if masked:
        batch["loss_mask"] = (rng.random((b, s)) < 0.8).astype(np.float32)
    return batch


def port_loss_and_grads(tm, batch):
    loss = tm.loss({k: torch.tensor(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, tree_leaves(tm.params))
    return float(loss.detach()), [g.numpy() for g in grads]


@pytest.mark.parametrize("s,impl_j,impl_t,masked", [(320, "chunked", "kernel", False),
                                                    (320, "chunked", "kernel", True),
                                                    (32, "naive", "naive", False)])
def test_loss_and_every_gradient_equal_reference(s, impl_j, impl_t, masked):
    """fp32, relative 1e-4. At S=320 both sides are past the Sq <= 256 naive
    shortcut: the reference in its chunked custom-VJP attention, the port in
    its autograd Function (plain forward and backward on the CPU)."""
    jm, jparams, tm = models(impl_j, impl_t)
    batch = batch_of(1, 2, s, tm.cfg.vocab_size, masked)
    want, wgrads = jax.value_and_grad(jm.loss)(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    got, grads = port_loss_and_grads(tm, batch)
    assert abs(got - float(want)) <= 1e-4 * abs(float(want))
    wleaves = jax.tree.leaves(wgrads)        # sorted-key order, as tree_leaves
    assert len(wleaves) == len(grads)
    for g, w in zip(grads, wleaves):
        assert g.shape == w.shape
        assert rel(g, w) <= 1e-4


def test_remat_modes_give_the_same_gradients():
    _, _, tm = models("chunked", "kernel")
    batch = batch_of(2, 2, 288, tm.cfg.vocab_size)
    want_loss, want = port_loss_and_grads(tm, batch)
    for remat in ("dots", "full"):
        other = LanguageModel(tm.cfg, impl="kernel", remat=remat)
        other.params = tm.params
        loss, grads = port_loss_and_grads(other, batch)
        assert loss == pytest.approx(want_loss, rel=1e-6)
        for g, w in zip(grads, want):
            np.testing.assert_allclose(g, w, atol=1e-6, rtol=1e-5)


def test_remat_is_checked():
    with pytest.raises(ValueError, match="remat"):
        LanguageModel(tconfigs.get(SMOKE), remat="some")
