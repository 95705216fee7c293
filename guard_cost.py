"""Development script: what the train guard costs the training thread, on
the card. Not part of the package or of ``chip_smoke.py``.

    python3 guard_cost.py [--rounds 4]

It builds the kernels (``chip_smoke.phase_build``), writes two seeded
MultiSlot files of 16 batches of B=2048 (4n's key mix), and trains them on
one flagship world (``chip_smoke``'s DeepFM over a ``DeviceTable`` of
4,194,304 prepopulated rows, device prep) through
``CTRTrainer.train_from_dataset``, the entry that hands the guard one
dispatch a step, in turns (the order rotating each round) under:

- ``off``: no guard;
- ``guard``: ``TrainGuard`` as the package has it (the hook queues the
  step's tensors, the poller wakes every ``lag`` steps and reads every
  ready entry with one copy and a wait on a blocking event);
- ``queue``: the guard's hook with no poller (entries queued, never read);
- ``copy_spin`` and ``copy_block``: the hook's first design, kept here to
  measure it: the hook copies each step's flags and loss into a fresh
  pinned buffer behind an event, the poller is woken every step and waits
  on each entry's event, spinning or blocking.

Prints ms/step of each turn, the medians, and the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import copy
import os
import sys

import numpy as np
import torch

import chip_smoke as cs
from paddlebox_tpu_torch.data.fast_feed import FastSlotReader
from paddlebox_tpu_torch.trainer.guard import GuardPolicy, TrainGuard


class CopyHookGuard(TrainGuard):
    """The first design: a pinned copy and an event a dispatch on the
    training thread, the poller woken at each and waiting on each."""

    blocking = False

    def _on_step_outputs(self, k, bad, loss):
        vals = torch.cat([bad.reshape(-1).float(), loss.reshape(-1).float()])
        host = torch.empty(vals.numel(), dtype=torch.float32,
                           pin_memory=True)
        host.copy_(vals, non_blocking=True)
        event = torch.cuda.Event(blocking=self.blocking)
        event.record()
        super()._on_step_outputs(k, host, event)
        with self._cond:
            self._cond.notify_all()

    def _read(self, entries):
        out = []
        with self._cuda_lock:
            for _e, _o, k, host, event in entries:
                event.synchronize()
                v = host.numpy().copy()
                out.append((v[:k] != 0, v[k:2 * k]))
        return out


class BlockingCopyHookGuard(CopyHookGuard):
    blocking = True


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("guard_cost: CUDA is not available", file=sys.stderr)
        return 1
    cs.phase_build()
    rng = np.random.default_rng([0, 59])
    os.makedirs(cs.WORK, exist_ok=True)
    files = [os.path.join(cs.WORK, f"guard-cost-{i}") for i in range(2)]
    for i, p in enumerate(files):
        cs.write_trainer_file(rng, p, (i % 2) * (cs.HOT_VOCAB + 1 +
                                                 i * (1 << 20)))
    conf, tconf, buckets = cs.train_confs()
    feed = cs.trainer_feed_conf()
    fb = cs.BucketSpec(min_size=cs.TNPAD, max_size=1 << 18)
    table = cs.DeviceTable(conf, capacity=cs.HOT_VOCAB + 1 + cs.FEED_HEADROOM,
                           uniq_buckets=buckets, device="cuda",
                           backend="native", index_threads=1)
    table.prepopulate(cs.HOT_VOCAB)
    model = cs.random_deepfm(np.random.default_rng(1), cs.TS * conf.pull_dim)
    tr = cs.CTRTrainer(copy.deepcopy(model), feed, conf, tconf, table=table,
                       buckets=fb)
    batches = cs.GuardBatches(list(FastSlotReader(feed, buckets=fb)
                                   .batches(files)))
    n = len(files) * cs.TRAINER_FILE_BATCHES
    for _ in range(2):
        tr.train_from_dataset(batches)          # warm
    guards = {"guard": TrainGuard(tr, policy=GuardPolicy()),
              "queue": TrainGuard(tr, policy=GuardPolicy()),
              "copy_spin": CopyHookGuard(tr, policy=GuardPolicy()),
              "copy_block": BlockingCopyHookGuard(tr, policy=GuardPolicy())}
    order = ["off", *guards]
    turns = {k: [] for k in order}
    for rnd in range(args.rounds):
        shift = rnd % len(order)
        for who in order[shift:] + order[:shift]:
            g = guards.get(who)
            if g is not None:
                g.attach()
                if who == "queue":
                    g._stop = True              # no poller spawns
            tr.reset_metrics()
            t, _ = cs.timed_secs(lambda: tr.train_from_dataset(batches))
            if g is not None:
                g.detach()
            turns[who].append(round(t / n * 1e3, 4))
    med = {k: round(float(np.median(v)), 4) for k, v in turns.items()}
    print(f"guard cost: train_from_dataset ms/step over {n} batches, one "
          f"world, in turns: {turns}; medians {med} [{cs.card_line()}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
