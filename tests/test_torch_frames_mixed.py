"""Port parity: frame and mixed inputs (HuBERT-XLarge, LLaVA-NeXT-Mistral-7B).

- Both configs convert from the reference's field for field, with the
  reference's aliases; ``synthesize_batch`` draws the reference's arrays.
- ``forward`` logits, ``train_loss`` and every gradient of the reduced
  HuBERT (float32, bidirectional attention, GELU FFN; also with heads of
  80) and of the reduced LLaVA (16 image slots ahead of the text, the
  image positions out of the loss) against the reference's, from weights
  converted from the reference's init (``frontend_proj``, ``img_proj``,
  no ``embed`` for frames), with ``use_pallas`` off and on (the port's
  kernels through their plain versions; the reference's Pallas kernels in
  interpret mode).
- A 3-step float32 AdamW trajectory of each against the reference's
  ``make_train_step``; the port's step with two microbatches against its
  step with one.
- LLaVA's ``decode_step`` over 4 teacher-forced tokens against the
  reference's.
- A reference checkpoint of each restored into the port, then one more
  step from both.
- The refusals: ``decode_step`` on frames, the paged prefill on frame
  and mixed inputs, the serving launcher on an encoder, each with the
  reference's message.

Tolerances: those of ``tests/test_torch_dense.py`` — logits 1e-4, the
loss 1e-5 relative, its gradients 1e-4 relative over a floor of 1e-4
times each leaf's scale; the trajectory's losses 1e-4, every parameter
within the sum of the step sizes and all but a 1e-4 share of each leaf's
elements within 2e-3 of the learning rate; two microbatches against one
1e-5 relative on the loss and the trajectory's bounds on the parameters
(the same float32 sums grouped by microbatch).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config
from repro.configs.base import TrainConfig as JTrainConfig
from repro.data.pipeline import synthesize_batch as j_synthesize
from repro.models import transformer as JT
from repro.train.loop import make_train_step as j_make_train_step
from repro.train.optimizer import init_adamw as j_init_adamw
from torch_parity import f32, np_params, to_torch, torch_config
from torch_parity import tp  # noqa: F401

BATCH, SEQ = 2, 64
HUBERT = get_config("hubert_xlarge").reduced()
HUBERT_80 = HUBERT.replace(head_dim=80)
LLAVA = get_config("llava_next_mistral_7b").reduced()
MODELS = {"hubert": HUBERT, "hubert-dh80": HUBERT_80, "llava": LLAVA}


def _batch(jcfg, seed=0, batch=BATCH):
    return j_synthesize(jcfg, batch, SEQ, seed=seed)


def _port_params(tp, jp, tcfg):
    return tp.interop.params_from_jax(np_params(jp), tcfg, device="cpu",
                                      dtype=tp.torch.float32)


def _torch_batch(batch):
    return {k: to_torch(v) for k, v in batch.items()}


def _close_leaves(tp, got, want_tree, tcfg):
    from repro_torch.train.optimizer import tree_leaves
    want = tree_leaves(_port_params(tp, want_tree, tcfg))
    assert len(want) == len(got)
    for i, (g, w) in enumerate(zip(got, want)):
        w = f32(w)
        np.testing.assert_allclose(f32(g), w, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(w).max()),
                                   err_msg=f"leaf {i}")


@pytest.mark.parametrize("arch,alias", [
    ("hubert_xlarge", "hubert-xlarge"),
    ("llava_next_mistral_7b", "llava-next-mistral-7b")])
def test_config_converts_field_for_field(arch, alias):
    from repro_torch.configs import ARCH_IDS
    from repro_torch.configs import get_config as t_get_config
    ref = get_config(arch)
    port = t_get_config(alias)
    assert arch in ARCH_IDS
    assert port == torch_config(ref) == t_get_config(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.reduced() == torch_config(ref.reduced())


@pytest.mark.parametrize("arch,seq", [
    ("hubert_xlarge", 64), ("llava_next_mistral_7b", 64),
    ("llava_next_mistral_7b", 6144), ("yi_6b", 33)])
def test_synthesize_batch_matches_reference(arch, seq):
    """Array for array: the same keys, dtypes, shapes and values (LLaVA
    at 6144 positions: all 2880 image slots and 3264 text tokens)."""
    from repro_torch.configs import get_config as t_get_config
    from repro_torch.data.pipeline import synthesize_batch
    want = j_synthesize(get_config(arch), 2, seq, seed=3)
    got = synthesize_batch(t_get_config(arch), 2, seq, seed=3)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(
            got[k], want[k]), k
    if seq == 6144:
        assert got["image_embeds"].shape == (2, 2880, 4096)
        assert got["tokens"].shape == (2, 3264)


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "pallas"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_loss_grads_and_logits_match_reference(tp, name, use_pallas):
    """Logits, ``train_loss`` and every gradient, from the same weights
    and batch."""
    from repro_torch.train.optimizer import tree_leaves
    jcfg = MODELS[name].replace(use_pallas=use_pallas)
    tcfg = torch_config(jcfg)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    batch = _batch(jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss_ref, _), grads_ref = jax.value_and_grad(
        lambda p: JT.train_loss(p, jbatch, jcfg), has_aux=True)(jp)
    logits_ref, _ = JT.forward(jp, jbatch, jcfg)
    params = _port_params(tp, jp, tcfg)
    top = {k for k in params if k != "layers"}
    assert top == {k for k in jp if k != "layers"}
    assert ("embed" in top) == (jcfg.input_kind == "mixed")
    tbatch = _torch_batch(batch)
    with tp.torch.no_grad():
        logits, _ = tp.transformer.forward(params, tbatch, tcfg)
    want = f32(logits_ref)
    assert logits.shape == want.shape == (BATCH, SEQ, jcfg.vocab_size)
    np.testing.assert_allclose(f32(logits), want, rtol=1e-4, atol=1e-4)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, met = tp.transformer.train_loss(params, tbatch, tcfg)
    grads = tp.torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(loss_ref),
                               rtol=1e-5)
    assert float(met["aux"]) == 0.0
    _close_leaves(tp, grads, grads_ref, tcfg)


def test_last_only_and_the_loss_positions(tp):
    """``last_only`` gives the full forward's last position; LLaVA's loss
    is the cross entropy over the text positions only (image positions
    carry none), HuBERT's over every frame's own label (no shift)."""
    torch = tp.torch
    for jcfg in (HUBERT, LLAVA):
        tcfg = torch_config(jcfg)
        params = tp.interop.init_params(tcfg, device="cpu")
        tbatch = _torch_batch(_batch(jcfg, seed=1))
        with torch.no_grad():
            full, _ = tp.transformer.forward(params, tbatch, tcfg)
            last, _ = tp.transformer.forward(params, tbatch, tcfg,
                                             last_only=True)
            loss, _ = tp.transformer.train_loss(params, tbatch, tcfg)
        assert last.shape == (BATCH, 1, jcfg.vocab_size)
        torch.testing.assert_close(last, full[:, -1:], rtol=1e-5, atol=1e-5)
        labels = tbatch["labels"].long()
        if jcfg.input_kind == "mixed":
            n_img = tbatch["image_embeds"].shape[1]
            logits, labels = full[:, n_img:-1], labels[:, 1:]
        else:
            logits = full
        want = torch.nn.functional.cross_entropy(
            logits.reshape(-1, jcfg.vocab_size), labels.reshape(-1))
        torch.testing.assert_close(loss, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_three_step_trajectory_matches_reference(tp, name):
    from repro_torch.configs import TrainConfig
    from repro_torch.train.loop import train
    from repro_torch.train.optimizer import tree_leaves
    jcfg = MODELS[name]
    tcfg_m = torch_config(jcfg)
    jt = JTrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=3,
                      batch_size=BATCH, seq_len=SEQ, log_every=1)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    step = jax.jit(j_make_train_step(jcfg, jt))
    batches = [_batch(jcfg, seed=s) for s in range(3)]
    jp, jopt = jparams, j_init_adamw(jparams)
    losses_ref = []
    for batch in batches:
        jp, jopt, m = step(jp, jopt, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
        losses_ref.append(float(m["loss"]))
    fields = {f.name for f in dataclasses.fields(TrainConfig)}
    tcfg = TrainConfig(**{k: v for k, v in dataclasses.asdict(jt).items()
                          if k in fields})
    params, _, history = train(tcfg_m, tcfg, device="cpu",
                               params=_port_params(tp, jparams, tcfg_m),
                               batch_iterator=iter(batches),
                               log=lambda _: None)
    np.testing.assert_allclose([h["loss"] for h in history], losses_ref,
                               rtol=1e-4)
    lr_sum = sum(h["lr"] for h in history)
    for i, (got, want) in enumerate(zip(
            tree_leaves(params), tree_leaves(_port_params(tp, jp, tcfg_m)))):
        err = np.abs(f32(got) - f32(want))
        assert err.max() <= lr_sum, (i, err.max())
        n_far = int((err > 2e-3 * jt.learning_rate).sum())
        assert n_far <= 1e-4 * err.size, (i, n_far, err.size)


@pytest.mark.parametrize("name", ["hubert", "llava"])
def test_two_microbatches_match_one(tp, name):
    """A step over two microbatches of a 4-row batch (features or image
    embeddings split with the tokens and labels) against the step over
    the whole batch."""
    from repro_torch.configs import TrainConfig
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import init_adamw, tree_leaves
    tcfg_m = torch_config(MODELS[name])
    batch = _batch(MODELS[name], seed=4, batch=4)
    out = {}
    for m in (1, 2):
        tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=0,
                           total_steps=3, batch_size=4, seq_len=SEQ,
                           num_microbatches=m)
        params = tp.interop.init_params(
            tcfg_m, tp.torch.Generator().manual_seed(0), "cpu",
            dtype=tp.torch.float32)
        params, _, met = make_train_step(tcfg_m, tcfg, "cpu")(
            params, init_adamw(params), batch)
        out[m] = (float(met["loss"]), tree_leaves(params))
    np.testing.assert_allclose(out[2][0], out[1][0], rtol=1e-5)
    for i, (a, b) in enumerate(zip(out[2][1], out[1][1])):
        err = np.abs(f32(a) - f32(b))
        assert err.max() <= 1e-3, (i, err.max())
        assert int((err > 2e-6).sum()) <= 1e-4 * err.size, i


def test_llava_decode_steps_match_reference(tp):
    """``init_cache`` then 4 teacher-forced ``decode_step`` calls (B=2) on
    the reduced LLaVA, a token stream as the reference decodes it: every
    step's logits against the reference's."""
    T = tp.transformer
    tcfg = torch_config(LLAVA)
    jp = JT.init_params(jax.random.PRNGKey(5), LLAVA)
    params = _port_params(tp, jp, tcfg)
    toks = np.random.default_rng(6).integers(
        0, LLAVA.vocab_size, size=(2, 4)).astype(np.int32)
    jcache = JT.init_cache(LLAVA, 2, 16)
    tcache = T.init_cache(tcfg, 2, 16, "cpu")
    jstep = jax.jit(lambda c, t, pos: JT.decode_step(jp, c, {"tokens": t},
                                                     pos, LLAVA))
    for t in range(4):
        want, jcache = jstep(jcache, jnp.asarray(toks[:, t:t + 1]), t)
        with tp.torch.no_grad():
            got, tcache = T.decode_step(params, tcache,
                                        {"tokens": to_torch(toks[:, t:t + 1])},
                                        t, tcfg)
        want = f32(want)
        np.testing.assert_allclose(f32(got), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=f"step {t}")


@pytest.mark.parametrize("name", ["hubert", "llava"])
def test_restores_a_reference_checkpoint(tp, tmp_path, name):
    """A checkpoint that the reference's ``save_checkpoint`` wrote after
    one step (with ``frontend_proj`` and no ``embed`` for HuBERT, with
    ``img_proj`` and ``embed`` for LLaVA) restores in the port: every leaf
    and moment equal to the reference's exactly; one more step from both
    agrees to the trajectory's tolerances."""
    from repro.train.checkpointing import save_checkpoint as j_save
    from repro_torch.configs import TrainConfig
    from repro_torch.train.checkpointing import _flatten, restore_checkpoint
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import init_adamw
    jcfg = MODELS[name]
    tcfg_m = torch_config(jcfg)
    jt = JTrainConfig(learning_rate=1e-3, warmup_steps=0, total_steps=4,
                      batch_size=BATCH, seq_len=SEQ)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    step = jax.jit(j_make_train_step(jcfg, jt))
    batches = [{k: jnp.asarray(v) for k, v in _batch(jcfg, seed=s).items()}
               for s in range(2)]
    jp, jopt, _ = step(jp, j_init_adamw(jp), batches[0])
    j_save(str(tmp_path / "ref"), 1, jp, jopt)
    template = tp.interop.init_params(tcfg_m, device="cpu",
                                      dtype=tp.torch.float32)
    proj = "frontend_proj" if name == "hubert" else "img_proj"
    assert proj in template and ("embed" in template) == (name == "llava")
    step_n, params, opt = restore_checkpoint(str(tmp_path / "ref"), template,
                                             init_adamw(template))
    assert step_n == 1 and opt.step == 1

    def by_path(np_tree):
        return _flatten(_port_params(tp, np_tree, tcfg_m))

    want, got = by_path(jp), _flatten(params)
    assert list(got) == list(_flatten(template))
    for key, t in got.items():
        assert tp.torch.equal(t, want[key]), key
    for moment in ("mu", "nu"):
        ref_tree = by_path(getattr(jopt, moment))
        for key, t in zip(got, getattr(opt, moment)):
            assert tp.torch.equal(t, ref_tree[key]), (moment, key)
    jp2, _, m = step(jp, jopt, batches[1])
    fields = {f.name for f in dataclasses.fields(TrainConfig)}
    tcfg = TrainConfig(**{k: v for k, v in dataclasses.asdict(jt).items()
                          if k in fields})
    params, _, m_port = make_train_step(tcfg_m, tcfg, "cpu")(
        params, opt, {k: to_torch(np.asarray(v))
                      for k, v in batches[1].items()})
    np.testing.assert_allclose(float(m_port["loss"]), float(m["loss"]),
                               rtol=1e-4)
    lr = float(m["lr"])
    want = by_path(jp2)
    for key, t in _flatten(params).items():
        err = np.abs(f32(t) - f32(want[key]))
        assert err.max() <= lr, (key, err.max())
        assert int((err > 2e-3 * lr).sum()) <= 1e-4 * err.size, key


def test_refusals_match_reference(tp):
    """An encoder does not decode (``decode_step``, the serving launcher);
    the paged prefill decodes token streams only (HuBERT's frames and
    LLaVA's images), each with the reference's message; the reference's
    ``prefill`` raises the same."""
    from repro_torch.launch import serve as launch_serve
    T = tp.transformer
    for jcfg in (HUBERT, LLAVA):
        tcfg = torch_config(jcfg)
        params = tp.interop.init_params(tcfg, device="cpu")
        cache = T.init_paged_cache(tcfg, 4, 16, "cpu")
        toks = tp.torch.zeros(1, 8, dtype=tp.torch.int32)
        args = (toks, tp.torch.tensor([8], dtype=tp.torch.int32), cache,
                tp.torch.tensor([[1]], dtype=tp.torch.int32), tcfg)
        with pytest.raises(ValueError, match="decodes token streams"):
            T.prefill(params, *args)
        with pytest.raises(ValueError, match="decodes token streams"):
            JT.prefill(JT.init_params(jax.random.PRNGKey(0), jcfg),
                       jnp.zeros((1, 8), jnp.int32),
                       jnp.array([8], jnp.int32),
                       JT.init_paged_cache(jcfg, 4, 16),
                       jnp.array([[1]], jnp.int32), jcfg)
    with pytest.raises(ValueError, match="encoder-only"):
        T.decode_step({}, [], {"tokens": None}, 0, torch_config(HUBERT))
    with pytest.raises(SystemExit, match="encoder-only; nothing to decode"):
        launch_serve.main(["--arch", "hubert-xlarge", "--reduced",
                           "--device", "cpu"])
