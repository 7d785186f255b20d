"""Port parity: the peak-memory simulator (``core/memsim.py``).

Shape arithmetic only, so every number must equal the reference's
exactly: the train-step timeline of ``simulate`` (every phase's name,
held, transient and collective bytes, the base bytes, the recompute bytes,
the peak and its phase) and ``simulate_peak``, over the reference memory
bench's two small configs, Mixtral-8x7B, Qwen3-14B, two of the paper's
Table-1 configs, HuBERT-XLarge and LLaVA-NeXT-Mistral-7B, x every candidate plan of ``fit_candidates`` x the MoE
modes ``single`` / ``ep`` / ``ep_a2a`` x the three bases; then
``param_bytes``, ``moe_layer_sizes``, the KV byte functions and
``simulate_serve``.
"""

import dataclasses

import pytest

from repro.bench.memory import bench_config, bench_dense_config
from repro.configs import get_config
from repro.core import checkpoint as JCK
from repro.core import memsim as JMS
from torch_parity import torch_config

CONFIGS = {
    "bench_moe": bench_config(),
    "bench_dense": bench_dense_config(),
    "mixtral": get_config("mixtral_8x7b"),
    "qwen3_14b": get_config("qwen3_14b"),
    "paper_conf2": get_config("paper_conf2"),
    "paper_conf3": get_config("paper_conf3"),
    "hubert_xlarge": get_config("hubert_xlarge"),
    "llava_next_mistral_7b": get_config("llava_next_mistral_7b"),
}
MODES = (("single", 1), ("ep", 2), ("ep", 4), ("ep_a2a", 2), ("ep_a2a", 4))


def _port():
    from repro_torch.core import checkpoint as CK
    from repro_torch.core import memsim as MS
    return CK, MS


def _timeline(t) -> dict:
    return dict(phases=[dataclasses.astuple(p) for p in t.phases],
                base_bytes=t.base_bytes, base=t.base, mode=t.mode,
                n_model=t.n_model, recompute_bytes=t.recompute_bytes,
                peak_bytes=t.peak_bytes, peak_phase=t.peak_phase)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_simulate_matches_reference(name):
    CK, MS = _port()
    jcfg = CONFIGS[name]
    tcfg = torch_config(jcfg)
    specs = [p.spec() for p in JCK.fit_candidates(jcfg)]
    assert specs == [p.spec() for p in CK.fit_candidates(tcfg)]
    n_checked = 0
    for n_tokens, batch in ((64, 2), (4096, 2)):
        for spec in specs:
            for mode, n_model in MODES:
                if mode != "single" and not jcfg.is_moe:
                    continue
                for base in ("acts", "grad", "train"):
                    kw = dict(batch=batch, mode=mode, n_model=n_model,
                              base=base)
                    want = JMS.simulate(jcfg, n_tokens,
                                        plan=JCK.get_plan(spec), **kw)
                    got = MS.simulate(tcfg, n_tokens,
                                      plan=CK.get_plan(spec), **kw)
                    assert _timeline(got) == _timeline(want), (
                        name, n_tokens, spec, mode, n_model, base)
                    assert got.table() == want.table()
                    assert MS.simulate_peak(
                        tcfg, n_tokens, plan=spec, **kw) == \
                        JMS.simulate_peak(jcfg, n_tokens, plan=spec, **kw)
                    n_checked += 1
    assert n_checked >= 2 * len(specs) * 3


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_param_and_layer_bytes_match_reference(name):
    _, MS = _port()
    jcfg = CONFIGS[name]
    tcfg = torch_config(jcfg)
    for n_model in (1, 2, 4):
        assert MS.param_bytes(tcfg, n_model=n_model) == \
            JMS.param_bytes(jcfg, n_model=n_model)
    if jcfg.is_moe:
        for mode, n_model in MODES + (("tp", 2), ("ep_a2a_hier", 2)):
            kw = dict(mode=mode, n_model=n_model,
                      n_node=2 if mode == "ep_a2a_hier" else 1)
            assert dataclasses.astuple(MS.moe_layer_sizes(
                tcfg, 4096, **kw)) == dataclasses.astuple(
                JMS.moe_layer_sizes(jcfg, 4096, **kw)), kw


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_serving_bytes_match_reference(name):
    _, MS = _port()
    jcfg = CONFIGS[name]
    tcfg = torch_config(jcfg)
    for quantized in (False, True):
        assert MS.kv_bytes_per_token(tcfg, quantized=quantized) == \
            JMS.kv_bytes_per_token(jcfg, quantized=quantized)
        assert MS.kv_page_bytes(tcfg, 33, 16, quantized=quantized) == \
            JMS.kv_page_bytes(jcfg, 33, 16, quantized=quantized)
    assert MS.kv_bytes_per_token(tcfg, dtype="bfloat16") == \
        JMS.kv_bytes_per_token(jcfg, dtype="bfloat16")
    assert MS.dense_slot_bytes(tcfg, 4, 512, dtype="bfloat16") == \
        JMS.dense_slot_bytes(jcfg, 4, 512, dtype="bfloat16")
    for kw in (dict(batch_slots=4, num_pages=129, page_size=16,
                    prefill_tokens=2048, prefill_batch=4),
               dict(batch_slots=2, num_pages=65, page_size=16,
                    prefill_tokens=300, quantized=True, shared_pages=3),
               dict(batch_slots=8, num_pages=257, page_size=32,
                    prefill_tokens=4096, prefill_batch=2, n_model=2)):
        assert _timeline(MS.simulate_serve(tcfg, **kw)) == \
            _timeline(JMS.simulate_serve(jcfg, **kw)), kw
