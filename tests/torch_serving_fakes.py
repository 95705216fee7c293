"""Stand-in predictors for the port's serving tests (no test collected
here): the reference's ``tools/serving_drill.py`` fakes, with the port's
feed config, so a process-scope replica child builds one from a worker
spec without importing torch or the JAX package."""

import os
import time

import numpy as np

from paddlebox_tpu_torch.config import DataFeedConfig, SlotConfig

HERE = os.path.dirname(os.path.abspath(__file__))


def feed_conf() -> DataFeedConfig:
    return DataFeedConfig(
        slots=[SlotConfig("label", type="float", is_dense=True, dim=1),
               SlotConfig("slot_a"), SlotConfig("slot_b")],
        batch_size=8)


def lines(rng: np.random.Generator, n: int):
    """``n`` MultiSlot lines of :func:`feed_conf` (the reference drill's
    generator)."""
    return [f"1 {int(rng.integers(0, 2))} 2 {rng.integers(1, 99)} "
            f"{rng.integers(1, 99)} 1 {rng.integers(1, 99)}"
            for _ in range(n)]


class FakePredictor:
    """Serving-shaped stand-in with a set latency: 0.5 for every row."""

    def __init__(self, conf: DataFeedConfig, delay_s: float,
                 version: str = "drill/00001", wrapper=None):
        self.feed_conf = conf
        self.delay_s = delay_s
        self.model_version = version
        self.wrapper = wrapper

    def predict_records(self, records):
        time.sleep(self.delay_s)
        if self.wrapper is not None:
            self.wrapper.launches += 1       # one launch for each batch
        return np.full(len(records), 0.5, dtype=np.float32)


def make_fake(delay_s: float = 0.002, version: str = "drill/00001",
              poison_path: str = "", count_launches: bool = False):
    """The child's factory; an existing ``poison_path`` makes it raise on
    every start (a bad bundle's crash loop). ``count_launches`` counts
    each batch on the seqpool wrapper's launch counter, as a predictor on
    the card counts its kernel's launches (this imports torch)."""
    if poison_path and os.path.exists(poison_path):
        raise RuntimeError(f"poisoned bundle marker at {poison_path}")
    wrapper = None
    if count_launches:
        from paddlebox_tpu_torch.ops.seqpool_kernel import seqpool_cvm_cuda
        wrapper = seqpool_cvm_cuda
    return FakePredictor(feed_conf(), delay_s, version=version,
                         wrapper=wrapper)


def fake_spec(**kwargs):
    """A worker spec (``serving/proc.py``) of a fake-predictor child."""
    return {"module": "torch_serving_fakes", "qualname": "make_fake",
            "kwargs": kwargs, "sys_path": [HERE]}
