"""The embedded (no-Python) serving export (counterpart of
``paddlebox_tpu/inference/export_hlo.py``).

``export_embedded_bundle`` turns a serving bundle into a directory that
``csrc/pbx_serve.cpp`` (``ops/_build.py``'s executable route) scores with
no Python in the process:

- ``table.keys.u64`` / ``table.vals.f32``: the live keys of the bundle's
  table in its order (key 0 dropped) and their pull values after the
  embedx gating, flat, in the reference's byte formats. The loader's sparse
  side is a hash lookup and a row gather (``csrc/pbx_index.cpp``'s
  ``pbx_map_*`` and ``pbx_gather_rows``); an unknown key scores with zeros.
- ``manifest.txt``: ``npad``, ``batch``, ``slots``, ``pull_dim``,
  ``dense_dim`` and ``rows``, the reference's keys, byte for byte.
- ``layout.txt`` (the port's): the pool's ``use_cvm`` and ``cvm_offset``,
  and ``groups``, one token a space-separated group of an input line in
  its order (``L`` the label, ``S`` a used sparse slot, ``D<n>`` a used
  dense slot of n floats, ``X`` a group the loader skips), so the loader
  parses the feed's MultiSlot lines as ``SlotParser`` does.
- ``dense_fwd.ep.pt2``: a ``torch.export`` program of the model and its
  sigmoid with the weights in it; inputs the pooled features
  [B, S * out_dim] float32 and the dense values [B, dense_dim]; output the
  scores [B] ([B, T] for a multi-task model).
- ``dense_fwd.aoti.pt2``: the same program compiled by AOTInductor for the
  card (only an export on ``cuda`` writes it); the loader runs it through
  ``torch::inductor::AOTIModelPackageLoader``.

The pool stays outside both programs: the loader runs it through the
hand-written seqpool+CVM kernel (``csrc/seqpool_cvm.cu``), so no compiler
generates the counterpart of the TPU kernel. The reference's exported
graph holds its pool (``step._predict``); this boundary is a divergence
kept on purpose.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
from typing import Optional

import numpy as np
import torch
from torch import nn

from paddlebox_tpu_torch._device import DeviceLike
from paddlebox_tpu_torch.inference.predictor import CTRPredictor

EP_FILE = "dense_fwd.ep.pt2"
AOTI_FILE = "dense_fwd.aoti.pt2"


class DenseForward(nn.Module):
    """The model and its sigmoid over the pooled features, flat."""

    def __init__(self, model: nn.Module, num_slots: int, out_dim: int):
        super().__init__()
        self.model = model
        self.num_slots = num_slots
        self.out_dim = out_dim

    def forward(self, pooled: torch.Tensor,
                dense: torch.Tensor) -> torch.Tensor:
        sparse = pooled.reshape(pooled.shape[0], self.num_slots,
                                self.out_dim)
        return torch.sigmoid(self.model(sparse, dense))


def line_groups(feed_conf) -> str:
    """The ``groups`` of ``layout.txt`` for a feed config."""
    # an ins_id and a logkey are one-token groups ahead of the slots
    out = ["X"] * (int(feed_conf.parse_ins_id) + int(feed_conf.parse_logkey))
    for s in feed_conf.slots:
        if s.type == "string" and s.is_used:
            raise ValueError(f"slot {s.name}: a used string slot needs the "
                             "side table of InputTableDataset, which the "
                             "embedded loader does not have")
        if s.type in ("uint64", "string") and not s.is_dense:
            out.append("S" if s.is_used else "X")
        elif s.name == feed_conf.label_slot:
            out.append("L")
        else:
            out.append(f"D{s.dim}" if s.is_used else "X")
    return " ".join(out)


def openmp_cxx() -> str:
    """The C++ compiler for AOTInductor's wrapper: its build passes
    ``-fopenmp`` on Linux, so the first of ``$CXX`` and ``g++`` that
    builds a shared object with it."""
    tried = []
    for cxx in dict.fromkeys(c for c in (os.environ.get("CXX"),
                                         shutil.which("g++")) if c):
        with tempfile.TemporaryDirectory() as d:
            src = os.path.join(d, "probe.cpp")
            with open(src, "w") as f:
                f.write("int probe() { return 0; }\n")
            res = subprocess.run([cxx, "-fopenmp", "-shared", "-fPIC", src,
                                  "-o", os.path.join(d, "probe.so")],
                                 capture_output=True, text=True)
        if res.returncode == 0:
            return cxx
        tried.append(f"{cxx}: {res.stderr.strip()[-200:]}")
    raise RuntimeError("no C++ compiler builds with -fopenmp, which "
                       f"AOTInductor's wrapper needs: {tried}")


def export_embedded_bundle(bundle_dir: str, out_dir: str, npad: int = 4096,
                           predictor: Optional[CTRPredictor] = None,
                           device: DeviceLike = None) -> str:
    """Export the serving bundle at ``bundle_dir`` (``save_inference_model``)
    to ``out_dir`` for the embedded loader; ``npad`` is the loader's static
    key count a batch. ``predictor`` (else a ``CTRPredictor`` on ``device``,
    default ``cuda``) supplies the table and the model."""
    p = predictor if predictor is not None else \
        CTRPredictor(bundle_dir, device=device)
    os.makedirs(out_dir, exist_ok=True)
    B = p.feed_conf.batch_size
    D = p.table_conf.pull_dim
    S, dd = p.num_slots, p.dense_dim
    cvm_offset = int(p._step.seqpool_kwargs.get("cvm_offset", 2))
    out_dim = D if p.use_cvm else D - cvm_offset

    # the sparse side: the bundle's keys in its order, gated pull values
    with np.load(os.path.join(bundle_dir, "table.npz")) as snap:
        keys = np.asarray(snap["keys"], dtype=np.uint64)
    keys = np.ascontiguousarray(keys[keys != 0])
    vals = p.table.pull(keys).cpu().numpy().astype(np.float32, copy=False)
    keys.tofile(os.path.join(out_dir, "table.keys.u64"))
    np.ascontiguousarray(vals).tofile(os.path.join(out_dir, "table.vals.f32"))
    with open(os.path.join(out_dir, "manifest.txt"), "w") as f:
        f.write(f"npad={npad}\n")
        f.write(f"batch={B}\n")
        f.write(f"slots={S}\n")
        f.write(f"pull_dim={D}\n")
        f.write(f"dense_dim={dd}\n")
        f.write(f"rows={keys.size}\n")
    with open(os.path.join(out_dir, "layout.txt"), "w") as f:
        f.write(f"use_cvm={int(p.use_cvm)}\n")
        f.write(f"cvm_offset={cvm_offset}\n")
        f.write(f"groups={line_groups(p.feed_conf)}\n")

    # the dense side: static shapes, the weights inside
    fwd = DenseForward(p.model, S, out_dim).eval()
    example = (torch.zeros((B, S * out_dim), dtype=torch.float32,
                           device=p.device),
               torch.zeros((B, dd), dtype=torch.float32, device=p.device))
    with torch.no_grad():
        ep = torch.export.export(fwd, example)
    torch.export.save(ep, os.path.join(out_dir, EP_FILE))
    if p.device.type == "cuda":
        from torch._inductor import aoti_compile_and_package
        from torch._inductor import config as inductor_config
        # the predictor's precision: full float32 matmuls (no TF32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        with inductor_config.patch({"cpp.cxx": (openmp_cxx(),)}):
            aoti_compile_and_package(
                ep, package_path=os.path.join(out_dir, AOTI_FILE))
    return out_dir


__all__ = ["export_embedded_bundle", "DenseForward", "line_groups",
           "openmp_cxx", "EP_FILE", "AOTI_FILE"]
