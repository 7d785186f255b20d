"""Interleaved A/B of the two ways a checkpoint's arrays are read back.

Writes, with ``train/checkpointing.save_checkpoint``, a checkpoint of one
Mixtral-8x7B layer's expert leaves (``w1`` / ``w2`` (8, 4096, 14336) and
``w3`` (8, 14336, 4096), float32: 5.25 GiB), then restores it
``--rounds`` times in the order A B B A A B ...: A reads each member that
is stored uncompressed through a memory map
(``checkpointing._stored_arrays``, what ``restore_checkpoint`` does), B
with that reader switched off, so every member goes through ``np.load``.
Each restore runs twice: the whole tree, and rank 0's block of it on a
(data, model) = (2, 1) mesh under phase 47's ``tp`` specs (``w1``/``w2``
split along d, ``w3`` along its last dim), as ``chip_smoke.py`` phase 48
restores it.  The file is read from the page cache (it was just written):
the reads are warm.

    python tools/ckpt_restore_ab.py [--rounds 4] [--dir build/ckpt_ab]
        [--experts 8] [--d 4096] [--h 14336] [--out chiprun_out/ckpt_ab.json]

The last line of the output is a JSON summary: every restore's seconds
by reader and kind, and their medians.  Needs no card.
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.train import checkpointing as CK  # noqa: E402


class _Rank0:
    """Rank 0 of a (data, model) = (2, 1) mesh, as far as a restore asks."""
    shape = {"data": 2, "model": 1}
    axis_names = ("data", "model")

    def axis_size(self, ax):
        return self.shape[ax]

    def flat_index(self, ax):
        return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--dir", default=str(ROOT / "build" / "ckpt_ab"))
    ap.add_argument("--experts", type=int, default=8)
    ap.add_argument("--d", type=int, default=4096)
    ap.add_argument("--h", type=int, default=14336)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "ckpt_ab.json"))
    args = ap.parse_args()
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        card = "no card"
    E, d, h = args.experts, args.d, args.h
    shapes = {"w1": (E, d, h), "w2": (E, d, h), "w3": (E, h, d)}
    specs = {"w1": (None, "data", None), "w2": (None, "data", None),
             "w3": (None, None, "data")}
    path = Path(args.dir)
    shutil.rmtree(path, ignore_errors=True)
    t0 = time.perf_counter()
    tree = {k: torch.empty(s).uniform_() for k, s in shapes.items()}
    CK.save_checkpoint(str(path), 0, tree)
    del tree
    save_s = time.perf_counter() - t0
    nbytes = (path / "params.npz").stat().st_size
    meta = lambda s: torch.empty(s, device="meta")
    whole = {k: meta(s) for k, s in shapes.items()}
    block = {k: meta(tuple(n // (2 if ax else 1)
                           for n, ax in zip(s, specs[k])))
             for k, s in shapes.items()}
    mapped = CK._stored_arrays
    times = {r: {"whole": [], "block": []} for r in ("memmap", "np.load")}
    order = [("memmap", "np.load")[(i + 1) // 2 % 2]
             for i in range(2 * args.rounds)]
    for reader in order:
        CK._stored_arrays = mapped if reader == "memmap" else (lambda fn: {})
        for kind, tmpl, kw in (("whole", whole, {}),
                               ("block", block, {"mesh": _Rank0(),
                                                 "specs": specs})):
            t0 = time.perf_counter()
            out = CK.restore_checkpoint(str(path), tmpl, device="cpu", **kw)
            times[reader][kind].append(time.perf_counter() - t0)
            del out
        print(f"{reader}: whole {times[reader]['whole'][-1]:.2f} s, "
              f"rank 0's block {times[reader]['block'][-1]:.2f} s",
              flush=True)
    CK._stored_arrays = mapped
    shutil.rmtree(path, ignore_errors=True)
    summary = {"card": card, "file_bytes": nbytes, "save_s": save_s,
               "order": order, "seconds": times,
               "median_s": {r: {k: statistics.median(v)
                                for k, v in kinds.items()}
                            for r, kinds in times.items()}}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(summary))
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
