"""Port parity: the serving slice end to end on a reduced Mixtral.

Weights come from the reference's ``init_params`` and cross through
``repro_torch.interop.params_from_jax``.  The reference runs its default
expert layer (``moe_impl="blaze"``) and dense paged attention; the port
runs its kernel composition (``blaze_pallas``), or ``blaze`` on the
``pallas_fused`` backend, and its paged attention kernel, here through
their plain versions.  Everything is float32, so logits agree to 1e-4 (the
same sums in another order through two layers).

The engine's greedy tokens are held to the reference model's own greedy
decode (``forward`` over each prompt and the tokens so far), not to the
reference engine's tokens: that engine hands numpy buffers to jitted calls
that may alias them and then mutates them, so its tokens vary from run to
run (ROADMAP §C).  Its accounting depends only on lengths and scheduling,
and the port's must equal it.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config
from repro.models import transformer as JT
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from torch_parity import np_params, to_torch, torch_config, tp  # noqa: F401

JCFG = get_config("mixtral_8x7b").reduced()
TCFG = torch_config(JCFG).replace(moe_impl="blaze_pallas")
TCFG_FUSED = torch_config(JCFG).replace(gmm_backend="pallas_fused")
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def params(tp):
    jp = JT.init_params(jax.random.PRNGKey(0), JCFG)
    return jp, tp.interop.params_from_jax(np_params(jp), TCFG, device="cpu")


def test_prefill_and_decode_logits_match(tp, params):
    TT, torch = tp.transformer, tp.torch
    jp, tparams = params
    rng = np.random.default_rng(0)
    B, S, ps, pps = 2, 16, 8, 4
    lengths = np.array([5, 11], np.int32)
    tokens = np.zeros((B, S), np.int32)
    for b, n in enumerate(lengths):
        tokens[b, :n] = rng.integers(3, JCFG.vocab_size, size=n)
    table = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    n_pages = 1 + B * pps
    jcache = JT.init_paged_cache(JCFG, n_pages, ps)
    tcache = TT.init_paged_cache(TCFG, n_pages, ps, "cpu")
    jl, jcache = JT.prefill(jp, jnp.asarray(tokens), jnp.asarray(lengths),
                            jcache, jnp.asarray(table), JCFG)
    with torch.inference_mode():
        tl = TT.prefill(tparams, to_torch(tokens), to_torch(lengths), tcache,
                        to_torch(table), TCFG)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    pos = lengths.copy()
    for _ in range(3):                      # teacher-forced decode steps
        tok = rng.integers(3, JCFG.vocab_size, size=(B, 1)).astype(np.int32)
        jl, jcache = JT.paged_decode_step(jp, jcache, jnp.asarray(tok),
                                          jnp.asarray(pos),
                                          jnp.asarray(table), JCFG)
        with torch.inference_mode():
            tl = TT.paged_decode_step(tparams, tcache, to_torch(tok),
                                      to_torch(pos), to_torch(table), TCFG)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        pos += 1


STAT_KEYS = ("prefill_calls", "prefill_tokens", "decode_steps",
             "decode_slot_tokens", "generated_tokens", "blocked_admissions",
             "truncated_budgets", "peak_pages_used")


CAPACITY, MAX_NEW = 48, 6


def _engine_prompts():
    rng = np.random.default_rng(1)
    return [rng.integers(3, JCFG.vocab_size, size=n).astype(np.int32)
            for n in (3, 40, 17, 9, 25)]


@pytest.fixture(scope="module")
def greedy_ref(params):
    """The reference model's greedy continuation of each prompt: ``forward``
    over prompt + tokens so far, right-padded to the capacity (one compiled
    shape; causal, so the padding does not reach the real positions), the
    argmax at the last real position."""
    jp = params[0]
    fwd = jax.jit(lambda p, t: JT.forward(p, {"tokens": t}, JCFG)[0])
    prompts = _engine_prompts()
    seqs = [list(p) for p in prompts]
    for _ in range(MAX_NEW):
        toks = np.zeros((len(seqs), CAPACITY), np.int32)
        for i, q in enumerate(seqs):
            toks[i, :len(q)] = q
        logits = np.asarray(fwd(jp, jnp.asarray(toks)))
        for i, q in enumerate(seqs):
            q.append(int(logits[i, len(q) - 1].argmax()))
    return [q[len(p):] for q, p in zip(seqs, prompts)]


@pytest.mark.parametrize("num_pages,port_cfg", [
    (None, TCFG), (5, TCFG), (None, TCFG_FUSED)],
    ids=["full_budget", "tight_budget", "blaze_pallas_fused"])
def test_engine_greedy_tokens_and_stats_match(tp, params, greedy_ref,
                                              num_pages, port_cfg):
    """Mixed prompt lengths, three slots refilled as requests finish, and a
    48-token capacity on 16-token pages whose power-of-two prefill bucket
    (64) overshoots the 48-wide page table.  With 4 allocatable pages the
    head of the queue waits for pages (blocked admissions)."""
    jp, tparams = params
    prompts = _engine_prompts()
    kw = dict(batch_slots=3, capacity=CAPACITY, page_size=16,
              num_pages=num_pages)
    eos = JCFG.vocab_size              # outside the vocab: runs hit max_new
    jeng = JServeEngine(JCFG, jp, **kw)
    jreqs = jeng.generate([JRequest(prompt=p, max_new_tokens=MAX_NEW,
                                    eos_id=eos) for p in prompts])
    teng = tp.engine.ServeEngine(port_cfg, tparams, device="cpu", **kw)
    treqs = teng.generate([tp.engine.Request(prompt=p, max_new_tokens=MAX_NEW,
                                             eos_id=eos) for p in prompts])
    for want, j, t in zip(greedy_ref, jreqs, treqs):
        assert t.out_tokens == want
        assert t.finish_reason == j.finish_reason
    for k in STAT_KEYS:
        assert teng.stats[k] == jeng.stats[k], k
    if num_pages is not None:
        assert teng.stats["blocked_admissions"] > 0


def test_engine_without_device_needs_cuda(tp, params, monkeypatch):
    monkeypatch.setattr(tp.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.engine.ServeEngine(TCFG, params[1])


def test_engine_refuses_unported_options(tp, params):
    """No serving option still refuses as not ported: a mesh is taken, and
    a pairing of mode and mesh that cannot run is refused at construction
    with the reference engine's ValueError (tests/test_sharding.py:151:
    ``ep_a2a``, served as ``ep``, with 4 experts over 3 ranks); an SSM
    block pattern is refused with the reference engine's ValueError (it
    pages attention KV only); the options ported since (sampling, prefix
    sharing, the paged kernel choice, a per-request backend) are
    accepted."""
    from types import SimpleNamespace
    ServeEngine, Request = tp.engine.ServeEngine, tp.engine.Request
    mesh = SimpleNamespace(shape={"data": 1, "model": 3},
                           axis_names=("data", "model"))
    with pytest.raises(ValueError, match="divisible"):
        ServeEngine(TCFG.replace(moe_parallel="ep_a2a"), params[1],
                    device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="T.decode_step"):
        ServeEngine(TCFG.replace(block_pattern=("mlstm",)), params[1],
                    device="cpu")
    prompt = np.arange(3, 6, dtype=np.int32)
    for kw in (dict(greedy=False, temperature=0.7, seed=3),
               dict(prefix_cache=True), dict(paged_kernel="dense")):
        eng = ServeEngine(TCFG, params[1], device="cpu", **kw)
        r = eng.generate([Request(prompt=prompt, max_new_tokens=2)])[0]
        assert len(r.out_tokens) == 2
    eng = ServeEngine(TCFG, params[1], device="cpu")
    r = eng.generate([Request(prompt=prompt, max_new_tokens=2,
                              gmm_backend="segment")])[0]
    assert len(r.out_tokens) == 2 and r.finish_reason == "length"


def test_train_entry_points_need_cuda_unless_cpu(tp, monkeypatch):
    from repro_torch.configs import TrainConfig
    from repro_torch.launch import train as launch_train
    from repro_torch.train.loop import make_train_step, train
    cfg = TCFG.replace(use_pallas=True)
    tcfg = TrainConfig(total_steps=1, batch_size=1, seq_len=16)
    monkeypatch.setattr(tp.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_train_step(cfg, tcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(cfg, tcfg, log=lambda _: None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", "mixtral-8x7b", "--reduced",
                           "--steps", "1"])
    assert make_train_step(cfg, tcfg, device="cpu").device.type == "cpu"
    step = make_train_step(cfg.replace(remat_policy="paper"), tcfg, "cpu")
    assert (step.resolved_plan.spec, step.resolved_plan.source) == \
        ("paper", "config")
    assert step.peak_sim_bytes > 0
    # two microbatches of a 4-row batch: the plan and the simulated peak
    # are those of the 2-row microbatch, the live batch
    step = make_train_step(cfg, tcfg.replace(batch_size=4,
                                             num_microbatches=2), "cpu")
    live = make_train_step(cfg, tcfg.replace(batch_size=2), "cpu")
    assert (step.resolved_plan.spec, step.resolved_plan.source) == \
        ("none", "config")
    assert step.peak_sim_bytes == live.peak_sim_bytes


def test_port_imports_no_jax_and_no_reference():
    """``import repro_torch``, CPU engine runs (Mixtral, also sampled with
    prefix sharing and through the async runtime; Qwen3-14B over bf16 and
    over int8 pages) and CPU training steps (``blaze_pallas``,
    ``blaze`` on ``pallas_fused`` under the default plan and under
    ``paper``, the dense Qwen3-14B, and ``ep_a2a`` on ``pallas`` over a
    one-rank mesh), with the checkpoint plans, the simulator, the
    baselines, the Table-1 configs, ``compat``, the training checkpoints
    and the Qwen3-30B-A3B config imported, and decode steps and a
    training step of reduced Hymba and xLSTM (``models/ssm.py``), and the
    dry run's modules (``launch.dryrun``, ``launch.specs``) imported, leave
    JAX and the reference package out of ``sys.modules``."""
    code = (
        "import sys, numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "import repro_torch\n"
        "from repro_torch.configs import TrainConfig, get_config\n"
        "from repro_torch.interop import init_params\n"
        "from repro_torch.serve.engine import Request, ServeEngine\n"
        "from repro_torch.train.loop import train\n"
        "import repro_torch.launch.train, repro_torch.launch.serve\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.specs\n"
        "import repro_torch.kernels.flash_attention\n"
        "import repro_torch.kernels.gmm_dw, repro_torch.data.pipeline\n"
        "import repro_torch.sharding, repro_torch.core.collectives\n"
        "import repro_torch.core.memsim, repro_torch.kernels.gather_rows\n"
        "import repro_torch.core.checkpoint, repro_torch.core.baseline\n"
        "import repro_torch.configs.paper_tables, repro_torch.compat\n"
        "import repro_torch.train.checkpointing\n"
        "import repro_torch.configs.qwen3_moe_30b_a3b\n"
        "assert get_config('qwen3-moe-30b-a3b').num_experts == 128\n"
        "from repro_torch.launch.mesh import init_distributed, "
        "make_debug_mesh\n"
        "cfg = get_config('mixtral-8x7b').reduced().replace("
        "moe_impl='blaze_pallas')\n"
        "p = init_params(cfg, torch.Generator().manual_seed(0), 'cpu')\n"
        "eng = ServeEngine(cfg, p, batch_slots=2, capacity=32, device='cpu')\n"
        "r = eng.generate([Request(prompt=np.arange(3, 9, dtype=np.int32),"
        " max_new_tokens=3)])[0]\n"
        "assert len(r.out_tokens) == 3\n"
        "from repro_torch.serve.runtime import AsyncServeRuntime\n"
        "eng = ServeEngine(cfg, p, batch_slots=2, capacity=32, device='cpu', "
        "greedy=False, temperature=0.8, prefix_cache=True)\n"
        "with AsyncServeRuntime(eng) as rt:\n"
        "    h = rt.submit(Request(prompt=np.arange(3, 20, dtype=np.int32),"
        " max_new_tokens=3))\n"
        "    assert len(h.result(timeout=60).out_tokens) == 3\n"
        "_, _, h = train(cfg.replace(use_pallas=True), TrainConfig("
        "total_steps=1, batch_size=1, seq_len=32), device='cpu', "
        "log=lambda _: None)\n"
        "assert np.isfinite(h[0]['loss'])\n"
        "fcfg = get_config('mixtral-8x7b').reduced().replace("
        "gmm_backend='pallas_fused', use_pallas=True)\n"
        "_, _, h = train(fcfg, TrainConfig(total_steps=1, batch_size=1, "
        "seq_len=32), device='cpu', log=lambda _: None)\n"
        "assert h[0]['gmm_backend'] == 'pallas_fused'\n"
        "assert np.isfinite(h[0]['loss'])\n"
        "_, _, h = train(fcfg.replace(remat_policy='paper'), TrainConfig("
        "total_steps=1, batch_size=1, seq_len=32), device='cpu', "
        "log=lambda _: None)\n"
        "assert h[0]['remat_plan'] == 'paper' and np.isfinite(h[0]['loss'])\n"
        "init_distributed('cpu')\n"
        "_, _, h = train(fcfg.replace(gmm_backend='pallas', moe_parallel="
        "'ep_a2a'), TrainConfig(total_steps=1, batch_size=1, seq_len=32), "
        "device='cpu', mesh=make_debug_mesh(1, 1), log=lambda _: None)\n"
        "assert np.isfinite(h[0]['loss']) and h[0]['moe_overflow'] == 0.0\n"
        "qcfg = get_config('qwen3-14b').reduced().replace("
        "dtype='bfloat16', use_pallas=True)\n"
        "qp = init_params(qcfg, torch.Generator().manual_seed(0), 'cpu')\n"
        "for kv in ('model', 'int8'):\n"
        "    eng = ServeEngine(qcfg, qp, batch_slots=2, capacity=32, "
        "kv_dtype=kv, device='cpu')\n"
        "    r = eng.generate([Request(prompt=np.arange(3, 9, "
        "dtype=np.int32), max_new_tokens=3)])[0]\n"
        "    assert len(r.out_tokens) == 3\n"
        "_, _, h = train(qcfg, TrainConfig(total_steps=1, batch_size=1, "
        "seq_len=32), device='cpu', log=lambda _: None)\n"
        "assert np.isfinite(h[0]['loss'])\n"
        "import repro_torch.models.ssm\n"
        "from repro_torch.models import transformer as T\n"
        "for a in ('hymba-1.5b', 'xlstm-1.3b'):\n"
        "    c = get_config(a).reduced().replace(num_layers=8 if a[0] == 'x'"
        " else 2, d_model=64, num_heads=2, vocab_size=64)\n"
        "    cp = init_params(c, torch.Generator().manual_seed(0), 'cpu')\n"
        "    cache = T.init_cache(c, 1, 8, 'cpu')\n"
        "    for t in range(3):\n"
        "        lg, cache = T.decode_step(cp, cache, {'tokens': "
        "torch.tensor([[t + 3]])}, t, c)\n"
        "    assert bool(torch.isfinite(lg).all())\n"
        "    _, _, h = train(c.replace(use_pallas=True), TrainConfig("
        "total_steps=1, batch_size=1, seq_len=32), device='cpu', "
        "log=lambda _: None)\n"
        "    assert np.isfinite(h[0]['loss'])\n"
        "for a in ('gemma2-27b', 'yi-6b', 'deepseek-coder-33b'):\n"
        "    assert T.paged_supported(get_config(a))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'ml_dtypes', 'repro'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout
