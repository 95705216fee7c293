"""Development script: ``CTRTrainer.train_from_dataset``'s device-prep pass
at the flagship's width, timed in two checkouts of the package in turns, on
the card. Not part of the package or of ``chip_smoke.py``.

    mkdir -p build/old && git archive d990f15 | tar -x -C build/old
    python3 pass_versions.py --old build/old

It runs one child process a turn, in the order old, new, new, old: each
imports ``paddlebox_tpu_torch`` from its checkout (``--old``, or the one
this script lives in), builds that checkout's kernels at first use, writes
one seeded MultiSlot file of 16 batches of B=2048 (a label and 24 slots of
1-3 keys uniform over 4,194,304 keys), loads it into a ``SlotDataset``
(Npad 102,400), and trains it with a ``CTRTrainer`` over a ``DeviceTable``
of 4,194,304 prepopulated rows, device prep (native one-thread index and
its mirror), the flagship DeepFM (hidden 512-256-128, adagrad table,
adam dense) from seeded weights: one warm-up pass, then ``--passes``
timed passes, each a host clock around the pass ended by a synchronize.
Only the entry points both checkouts have are used. Prints one JSON line
a turn and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
B, S, NPAD, VOCAB, BATCHES, HIDDEN = 2048, 24, 102400, 1 << 22, 16, \
    (512, 256, 128)


def write_file(path: str, seed: int) -> None:
    import numpy as np
    rng = np.random.default_rng(seed)
    rows = BATCHES * B
    lengths = rng.integers(1, 4, size=(rows, S))
    keys = rng.integers(1, VOCAB, size=int(lengths.sum())).astype(str)
    labels = rng.integers(0, 2, size=rows)
    pos = 0
    with open(path, "w") as f:
        for r in range(rows):
            parts = ["1", str(labels[r])]
            for j in range(S):
                n = int(lengths[r, j])
                parts.append(str(n))
                parts.extend(keys[pos:pos + n])
                pos += n
            f.write(" ".join(parts) + "\n")


def child(root: str, passes: int, data: str) -> None:
    sys.path.insert(0, root)
    import numpy as np
    import torch
    from paddlebox_tpu_torch.config import (BucketSpec, DataFeedConfig,
                                            SlotConfig, TableConfig,
                                            TrainerConfig)
    from paddlebox_tpu_torch.data.dataset import SlotDataset
    from paddlebox_tpu_torch.models.convert import deepfm_from_flax_leaves
    from paddlebox_tpu_torch.ps.device_table import DeviceTable
    from paddlebox_tpu_torch.trainer.trainer import CTRTrainer
    import paddlebox_tpu_torch
    assert Path(paddlebox_tpu_torch.__file__).resolve().parent.parent == \
        Path(root).resolve(), paddlebox_tpu_torch.__file__
    slots = [SlotConfig("label", type="float", is_dense=True, dim=1)]
    slots += [SlotConfig(f"s{i}") for i in range(S)]
    feed = DataFeedConfig(slots=slots, batch_size=B, label_slot="label")
    ds = SlotDataset(feed, buckets=BucketSpec(min_size=NPAD,
                                              max_size=1 << 18))
    ds.set_filelist([data])
    ds.load_into_memory()
    conf = TableConfig(embedx_dim=8, cvm_offset=3, embedx_threshold=0.0,
                       seed=7)
    table = DeviceTable(conf, capacity=VOCAB + 1 + (1 << 17),
                        uniq_buckets=BucketSpec(min_size=NPAD),
                        device="cuda", backend="native", index_threads=1)
    table.prepopulate(VOCAB)
    rng = np.random.default_rng(3)
    widths = [S * conf.pull_dim, *HIDDEN, 1]
    leaves = []
    for a, b in zip(widths[:-1], widths[1:]):
        leaves.append((rng.normal(size=b) * 0.01).astype(np.float32))
        leaves.append((rng.normal(size=(a, b)) / np.sqrt(a)).astype(
            np.float32))
    leaves.append(np.float32(rng.normal() * 0.1).reshape(()))
    tr = CTRTrainer(deepfm_from_flax_leaves(leaves, HIDDEN), feed, conf,
                    TrainerConfig(dense_optimizer="adam",
                                  dense_learning_rate=1e-3), table=table)
    assert tr.step.device_prep
    ms = []
    for i in range(passes + 1):
        tr.reset_metrics()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = tr.train_from_dataset(ds)
        torch.cuda.synchronize()
        if i:
            ms.append((time.perf_counter() - t0) / BATCHES * 1e3)
    print(json.dumps({"root": root, "ms_per_step": ms,
                      "auc": m["auc"], "rows": len(table)}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", help="root of the earlier checkout")
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--data", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child, args.passes, args.data)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("pass_versions: CUDA is not available", file=sys.stderr)
        return 1
    data = str(ROOT / "build" / "pass_versions.txt")
    os.makedirs(os.path.dirname(data), exist_ok=True)
    write_file(data, 0)
    old, new = str(Path(args.old).resolve()), str(ROOT)
    out = {"old": [], "new": []}
    for tag, root in (("old", old), ("new", new), ("new", new),
                      ("old", old)):
        res = subprocess.run(
            [sys.executable, str(ROOT / "pass_versions.py"), "--child",
             root, "--passes", str(args.passes), "--data", data],
            cwd=root, capture_output=True, text=True,
            env=dict(os.environ, PYTHONPATH=root))
        if res.returncode != 0:
            print(res.stdout, res.stderr, file=sys.stderr)
            return res.returncode
        line = json.loads(res.stdout.strip().splitlines()[-1])
        out[tag].append(line["ms_per_step"])
        print(f"pass_versions {tag} ({root}): {line}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
