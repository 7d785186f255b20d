"""Port parity: gradient accumulation and the training loop's per-step
backend.

- Microbatch invariance in the port, as ``tests/test_train.py``'s
  ``test_microbatch_invariance`` holds the reference: on one batch of 8,
  ``num_microbatches`` 1, 2 and 4 give the same loss, cross entropy and
  grad norm (1e-4 relative), the same updated parameters (5e-5 absolute)
  and the same AdamW first moments, a tenth of the clipped accumulated
  gradients (1e-4 relative over 1e-4 of each leaf's scale: the same
  float32 sums in another grouping).  On the reference's dense model and
  on a reduced Qwen3-30B-A3B without the load-balance loss (that loss is
  a product of two means over the tokens, so it is estimated per
  microbatch and is not invariant).
- The port's M = 2 step against the reference's M = 2 step from the same
  converted weights, with the load-balance loss on (both estimate it per
  microbatch): loss, ce and grad norm 1e-4 relative, parameters 5e-5
  absolute, first moments as above.
- ``peak_sim_bytes`` and the ``hbm_budget`` fit at M > 1 equal the
  reference's ``make_train_step`` at full width (the live batch is one
  microbatch); neither constructor allocates a parameter.
- ``train``'s step hook sees each step's backend, and a ``use_backend``
  scope entered in the hook changes exactly the next step, with losses
  equal to the uninterrupted run within 1e-4 (the reference's
  ``test_step_hook_reports_backend_and_context_flips_one_step``, on the
  same reduced model).

The learning rate of the first step is 0 (warmup 100, as in the
reference's test), so the parameters move only by weight decay times 0:
the moments carry the comparison of the accumulated gradients.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config
from repro.configs.base import TrainConfig as JTrainConfig
from repro.models import transformer as JT
from repro.train.loop import make_train_step as j_make_train_step
from repro.train.optimizer import init_adamw as j_init_adamw
from torch_parity import f32, np_params, torch_config
from torch_parity import tp  # noqa: F401

# the reference's test model (tests/test_train.py:16-18)
DENSE = get_config("yi_6b").reduced().replace(
    num_layers=2, d_model=64, num_heads=2, num_kv_heads=2, head_dim=32,
    d_ff=128, vocab_size=128)
# reduced Qwen3-30B-A3B with top-8 of 16 experts and a GQA group of 8
MOE = get_config("qwen3_moe_30b_a3b").reduced().replace(
    num_layers=2, d_model=64, num_heads=8, num_kv_heads=1, head_dim=16,
    num_experts=16, top_k=8, moe_d_ff=32, vocab_size=128)
MOE_NOAUX = MOE.replace(aux_loss_weight=0.0)
B, S = 8, 32


def _batch():
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (B, S), 0,
                                         DENSE.vocab_size), np.int32)
    return {"tokens": toks, "labels": toks}


def _tcfgs(M, **kw):
    from repro_torch.configs import TrainConfig
    jt = JTrainConfig(num_microbatches=M, learning_rate=1e-3, batch_size=B,
                      seq_len=S, **kw)
    fields = {f.name for f in dataclasses.fields(TrainConfig)}
    return jt, TrainConfig(**{k: v for k, v in dataclasses.asdict(jt).items()
                              if k in fields})


def _port_step(tp, jcfg, jparams, M):
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import init_adamw
    cfg = torch_config(jcfg)
    params = tp.interop.params_from_jax(np_params(jparams), cfg, device="cpu",
                                        dtype=tp.torch.float32)
    step = make_train_step(cfg, _tcfgs(M)[1], "cpu")
    params, opt, m = step(params, init_adamw(params), _batch())
    return params, opt.mu, {k: float(v) for k, v in m.items()}


def _moments_close(got, want, msg):
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = f32(a), f32(b)
        scale = float(np.abs(b).max())
        assert np.all(np.abs(a - b) <= 1e-4 * (np.abs(b) + scale)), \
            f"{msg}: moment of leaf {i}"


@pytest.mark.parametrize("jcfg", [DENSE, MOE_NOAUX], ids=["dense", "moe"])
def test_microbatch_invariance(tp, jcfg):
    from repro_torch.train.optimizer import tree_leaves
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    outs = {M: _port_step(tp, jcfg, jparams, M) for M in (1, 2, 4)}
    for M in (2, 4):
        for key in ("ce", "loss", "grad_norm"):
            np.testing.assert_allclose(outs[1][2][key], outs[M][2][key],
                                       rtol=1e-4, err_msg=f"M={M} {key}")
        for a, b in zip(tree_leaves(outs[1][0]), tree_leaves(outs[M][0])):
            np.testing.assert_allclose(f32(a), f32(b), atol=5e-5,
                                       err_msg=f"M={M}")
        _moments_close(outs[M][1], outs[1][1], f"M={M}")


@pytest.mark.parametrize("jcfg", [DENSE, MOE], ids=["dense", "moe"])
def test_two_microbatches_match_reference(tp, jcfg):
    from repro_torch.train.optimizer import tree_leaves
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    p1, o1, m1 = jax.jit(j_make_train_step(jcfg, _tcfgs(2)[0]))(
        jparams, j_init_adamw(jparams),
        {k: jnp.asarray(v) for k, v in _batch().items()})
    params, mu, m = _port_step(tp, jcfg, jparams, 2)
    cfg = torch_config(jcfg)
    port = lambda t: tree_leaves(tp.interop.params_from_jax(
        np_params(jax.device_get(t)), cfg, device="cpu",
        dtype=tp.torch.float32))
    for key in ("loss", "ce", "grad_norm"):
        np.testing.assert_allclose(m[key], float(m1[key]), rtol=1e-4,
                                   err_msg=key)
    for a, b in zip(tree_leaves(params), port(p1)):
        np.testing.assert_allclose(f32(a), f32(b), atol=5e-5)
    _moments_close(mu, port(o1.mu), "M=2 against the reference")


def test_peak_and_fit_at_microbatches_match_reference():
    """Full-width Mixtral-8x7B (2 layers, 8 x 2048 tokens, M = 4) and
    Qwen3-30B-A3B (4 layers, 2 x 2048, M = 2): the simulated peak under
    the default plan, and the plans fitted to budgets that fall between
    the candidates' simulated peaks at the whole batch.  The fit prices
    one microbatch, so some budget must choose another plan than it would
    at M = 1, and the simulated peak must not exceed M = 1's."""
    from repro.core import checkpoint as JCK
    from repro_torch.train.loop import make_train_step
    for arch, layers, batch, M in (("mixtral_8x7b", 2, 8, 4),
                                   ("qwen3_moe_30b_a3b", 4, 2, 2)):
        jcfg = get_config(arch).replace(num_layers=layers)
        cfg = torch_config(jcfg)
        jt, tt = _tcfgs(M)
        jt, tt = (dataclasses.replace(t, batch_size=batch, seq_len=2048)
                  for t in (jt, tt))
        whole = dataclasses.replace(tt, num_microbatches=1)
        peaks = sorted({r.sim_peak_bytes for r in JCK.CheckpointPlan.fit(
            jcfg, batch * 2048, 0, batch=batch).table})
        budgets = [p + 1 for p in peaks] + [(a + b) // 2 for a, b in
                                            zip(peaks, peaks[1:])]
        moved = False
        for kw in [{}] + [dict(hbm_budget=b) for b in budgets]:
            want = j_make_train_step(jcfg, jt, **kw)
            got = make_train_step(cfg, tt, "cpu", **kw)
            assert got.peak_sim_bytes == want.peak_sim_bytes, (arch, kw)
            assert (got.resolved_plan.spec, got.resolved_plan.source) == \
                (want.resolved_plan.spec, want.resolved_plan.source), kw
            at_one = make_train_step(cfg, whole, "cpu", **kw)
            assert got.peak_sim_bytes <= at_one.peak_sim_bytes, (arch, kw)
            moved |= got.resolved_plan.spec != at_one.resolved_plan.spec
        assert moved, arch


def test_step_hook_reports_backend_and_context_flips_one_step(tp):
    from repro_torch.configs import TrainConfig
    from repro_torch.core import gmm_backend as GB
    from repro_torch.train.loop import train
    jcfg = get_config("qwen3_moe_30b_a3b").reduced().replace(
        num_layers=2, d_model=64, num_heads=2, num_kv_heads=2, head_dim=32,
        num_experts=4, top_k=2, moe_d_ff=64, vocab_size=64, dtype="float32")
    cfg = torch_config(jcfg)
    auto = GB.resolve(None).name
    tcfg = TrainConfig(total_steps=3, batch_size=2, seq_len=16,
                       learning_rate=1e-3, log_every=1)
    quiet = lambda *_: None
    _, _, hist_ref = train(cfg, tcfg, device="cpu", log=quiet)
    assert [h["gmm_backend"] for h in hist_ref] == [auto] * 3
    scope = GB.use_backend("segment")
    seen = []

    def hook(step, metrics):
        seen.append(metrics["gmm_backend"])
        assert metrics["step_s"] > 0
        assert metrics["remat_plan"] == "none"
        assert metrics["peak_sim_bytes"] > 0
        if step == 0:
            scope.__enter__()
        elif step == 1:
            scope.__exit__(None, None, None)

    _, _, hist = train(cfg, tcfg, device="cpu", log=quiet, step_hook=hook)
    assert seen == [auto, "segment", auto]
    assert [h["gmm_backend"] for h in hist] == seen
    for h_ref, h in zip(hist_ref, hist):
        np.testing.assert_allclose(h_ref["loss"], h["loss"], rtol=1e-4,
                                   err_msg=f"step {h['step']}")
