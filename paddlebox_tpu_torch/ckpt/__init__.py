"""Crash-consistent checkpointing (counterpart of ``paddlebox_tpu/ckpt``):
the atomic commit protocol with manifest verification (``atomic``), named
crash points for drills (``faults``), the background snapshot-then-write
worker (``writer``), retention of bases and sweeping of staging spill
(``retention``) and the verified restore plan (``discovery``). Files and
directories keep the reference's layout, so a checkpoint written by either
package verifies and loads in the other."""
