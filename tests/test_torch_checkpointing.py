"""The port's training checkpoints (``repro_torch.train.checkpointing``).

- A round trip is bit-equal for float32 masters, bfloat16 serving weights
  and the AdamW state (step, first and second moments), into templates
  of other values (the mirror of ``tests/test_train.py``'s
  ``test_checkpoint_roundtrip``); the files are the reference's:
  ``manifest.json`` with ``step`` and ``files``, ``params.npz``,
  ``opt.npz``, bfloat16 stored as its ``uint16`` bit pattern.
- float32 masters restored into a serving template come back as the
  template's bfloat16 matrices and float32 norm scales, each rounded once.
- A leaf whose shape differs from the template's raises ``ValueError``
  naming its key.
- Two steps, a save and a restore into fresh templates, then two more
  steps: bit-equal to four uninterrupted steps (CPU, float32).
- The launchers: ``launch.train --ckpt-dir`` saves at step ``steps // 2``
  (as the reference's launcher does); ``launch.serve --ckpt`` serves those
  weights, with the tokens of an engine built from the restored tree.
"""

import json

import numpy as np
import pytest

from torch_parity import tp  # noqa: F401

ARCH = "qwen3-moe-30b-a3b"


def _cfg():
    from repro_torch.configs import get_config
    return get_config(ARCH).reduced().replace(use_pallas=True)


def _tcfg(**kw):
    from repro_torch.configs import TrainConfig
    return TrainConfig(learning_rate=1e-2, warmup_steps=1, total_steps=4,
                       batch_size=2, seq_len=32, **kw)


def _trained(tp, steps=1):
    """Float32 masters and an AdamW state after ``steps`` steps."""
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import init_adamw
    from repro_torch.data.pipeline import make_batch_iterator
    cfg, tcfg = _cfg(), _tcfg()
    params = tp.interop.init_params(cfg, tp.torch.Generator().manual_seed(0),
                                    "cpu", dtype=tp.torch.float32)
    opt = init_adamw(params)
    step = make_train_step(cfg, tcfg, "cpu")
    batches = make_batch_iterator(cfg.vocab_size, tcfg.seq_len,
                                  tcfg.batch_size, 0)
    for _ in range(steps):
        params, opt, _ = step(params, opt, next(batches))
    return params, opt


def _other(tree_leaf):
    """A template leaf of the same shape, dtype and device, other values."""
    return tree_leaf.detach().clone().fill_(7.0)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def test_round_trip_is_bit_equal(tp, tmp_path):
    from repro_torch.train.checkpointing import (restore_checkpoint,
                                                 save_checkpoint)
    from repro_torch.train.optimizer import AdamWState, tree_leaves
    torch = tp.torch
    params, opt = _trained(tp)
    assert opt.step == 1 and any(bool(m.any()) for m in opt.mu)
    save_checkpoint(str(tmp_path / "ck"), 7, params, opt)
    manifest = json.loads((tmp_path / "ck" / "manifest.json").read_text())
    assert manifest == {"step": 7, "files": ["params.npz", "opt.npz"]}
    tmpl_opt = AdamWState(step=0, mu=[_other(m) for m in opt.mu],
                          nu=[_other(v) for v in opt.nu])
    step, p2, o2 = restore_checkpoint(str(tmp_path / "ck"),
                                      _map(params, _other), tmpl_opt)
    assert step == 7 and o2.step == 1
    for a, b in zip(tree_leaves(params) + opt.mu + opt.nu,
                    tree_leaves(p2) + o2.mu + o2.nu):
        assert a.dtype == b.dtype and torch.equal(a.detach(), b)
    # bfloat16 serving weights: stored as their bit pattern
    served = _map(params, lambda t: t.detach().to(
        torch.bfloat16 if t.ndim > 1 else torch.float32))
    save_checkpoint(str(tmp_path / "bf16"), 0, served)
    with np.load(tmp_path / "bf16" / "params.npz") as data:
        assert data["embed"].dtype == np.uint16
        assert data["final_norm"].dtype == np.float32
        assert "layers/0/moe/w1" in data.files
    _, back = restore_checkpoint(str(tmp_path / "bf16"),
                                 _map(served, _other))
    for a, b in zip(tree_leaves(served), tree_leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_masters_restore_into_the_serving_layout(tp, tmp_path):
    from repro_torch.train.checkpointing import (restore_checkpoint,
                                                 save_checkpoint)
    from repro_torch.train.optimizer import tree_leaves
    torch = tp.torch
    params, _ = _trained(tp)
    save_checkpoint(str(tmp_path / "ck"), 1, params)
    serving = tp.interop.init_params(_cfg().replace(dtype="bfloat16"),
                                     torch.Generator().manual_seed(1), "cpu")
    _, got = restore_checkpoint(str(tmp_path / "ck"), serving)
    for master, tmpl, leaf in zip(tree_leaves(params), tree_leaves(serving),
                                  tree_leaves(got)):
        assert leaf.dtype == tmpl.dtype and leaf.device == tmpl.device
        assert torch.equal(leaf, master.detach().to(tmpl.dtype))
    assert got["layers"][0]["moe"]["w1"].dtype == torch.bfloat16
    assert got["layers"][0]["attn"]["q_norm"].dtype == torch.float32


def test_shape_mismatch_names_the_key(tp, tmp_path):
    from repro_torch.train.checkpointing import (restore_checkpoint,
                                                 save_checkpoint)
    params, _ = _trained(tp, steps=0)
    save_checkpoint(str(tmp_path / "ck"), 0, params)
    bad = _map(params, lambda t: t)
    bad["layers"][1]["moe"] = dict(bad["layers"][1]["moe"],
                                   w3=tp.torch.zeros(3, 5))
    with pytest.raises(ValueError, match=r"layers/1/moe/w3"):
        restore_checkpoint(str(tmp_path / "ck"), bad)


def test_resume_is_bit_equal_to_an_uninterrupted_run(tp, tmp_path):
    from repro_torch.data.pipeline import make_batch_iterator
    from repro_torch.train.checkpointing import (restore_checkpoint,
                                                 save_checkpoint)
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import AdamWState, init_adamw
    from repro_torch.train.optimizer import tree_leaves
    torch = tp.torch
    cfg, tcfg = _cfg(), _tcfg(num_microbatches=2)
    step = make_train_step(cfg, tcfg, "cpu")
    batches = list(zip(make_batch_iterator(cfg.vocab_size, tcfg.seq_len,
                                           tcfg.batch_size, 0), range(4)))

    def fresh():
        return tp.interop.init_params(cfg, torch.Generator().manual_seed(0),
                                      "cpu", dtype=torch.float32)

    p, o = fresh(), init_adamw(fresh())
    losses = []
    for b, _ in batches:
        p, o, m = step(p, o, b)
        losses.append(float(m["loss"]))
    q, r = fresh(), init_adamw(fresh())
    for b, _ in batches[:2]:
        q, r, _ = step(q, r, b)
    save_checkpoint(str(tmp_path / "ck"), 1, q, r)
    tmpl = _map(q, _other)
    _, q, r = restore_checkpoint(str(tmp_path / "ck"), tmpl, AdamWState(
        step=0, mu=[_other(m) for m in r.mu], nu=[_other(v) for v in r.nu]))
    resumed = []
    for b, _ in batches[2:]:
        q, r, m = step(q, r, b)
        resumed.append(float(m["loss"]))
    assert resumed == losses[2:] and r.step == o.step == 4
    for a, b in zip(tree_leaves(p) + o.mu + o.nu,
                    tree_leaves(q) + r.mu + r.nu):
        assert torch.equal(a.detach(), b.detach())


def test_launchers_save_and_serve_a_checkpoint(tp, tmp_path, capsys):
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.train.checkpointing import restore_checkpoint
    from repro_torch.train.optimizer import tree_leaves
    torch = tp.torch
    ckdir = tmp_path / "ck"
    launch_train.main(["--arch", ARCH, "--reduced", "--steps", "4",
                       "--batch", "2", "--seq", "32", "--microbatches", "2",
                       "--lr", "1e-2", "--log-every", "1", "--device", "cpu",
                       "--ckpt-dir", str(ckdir)])
    rec = json.loads(capsys.readouterr().out.split("run-record: ")[1])
    assert rec["microbatches"] == 2 and len(rec["history"]) == 4
    assert sorted(p.name for p in ckdir.iterdir()) == ["step_2"]
    manifest = json.loads((ckdir / "step_2" / "manifest.json").read_text())
    assert manifest["step"] == 2
    launch_serve.main(["--arch", ARCH, "--reduced", "--prompts", "2",
                       "--max-new", "4", "--device", "cpu", "--ckpt",
                       str(ckdir / "step_2")])
    out = capsys.readouterr().out
    rec = json.loads(out.split("run-record: ")[1])
    assert rec["checkpoint"] == str(ckdir / "step_2")
    served = [json.loads(line.split("-> ")[1].split(" [")[0])
              for line in out.splitlines() if line.startswith("req[")]
    cfg = _cfg().replace(use_pallas=False)
    init = tp.interop.init_params(cfg, torch.Generator().manual_seed(0),
                                  "cpu")
    _, params = restore_checkpoint(str(ckdir / "step_2"), init)
    assert not all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(init), tree_leaves(params)))
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(
        3, cfg.vocab_size, size=int(rng.integers(2, 9))).astype(np.int32),
        max_new_tokens=4) for _ in range(2)]
    ServeEngine(cfg, params, batch_slots=2, capacity=512,
                device="cpu").generate(reqs)
    assert [r.out_tokens for r in reqs] == served
