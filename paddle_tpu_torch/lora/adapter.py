"""LoRA adapter representation + sha256-manifested side-file artifacts
(port of ``paddle_tpu.lora.adapter``).

An adapter (Hu et al., ICLR 2022) is a named bundle of per-site low-rank
pairs ``A [in, r] / B [r, out]`` with one (rank, alpha) — site keys are
the dotted parallel-linear paths ``enable_lora`` returned for the model it
targets.  ``export_adapter`` / ``load_adapter`` write and read the JAX
package's artifact: one serialized payload (``framework.serialization``,
the format both packages share) plus a ``.manifest.json`` sidecar with the
artifact's sha256, format tag ``paddle_tpu.lora_adapter.v1``, so an
adapter exported by either package loads in the other.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..framework.errors import InvalidArgumentError
from .batched import DEFAULT_TARGETS, lora_targets

__all__ = [
    "LoraAdapter", "random_adapter", "merge_adapter",
    "export_adapter", "load_adapter", "ADAPTER_FORMAT",
]

ADAPTER_FORMAT = "paddle_tpu.lora_adapter.v1"


class LoraAdapter:
    """In-memory adapter: ``sites[dotted] = (A [in, r], B [r, out])``
    (numpy arrays)."""

    def __init__(self, name: str, rank: int, alpha: float,
                 sites: Dict[str, Tuple[np.ndarray, np.ndarray]]):
        self.name = str(name)
        self.rank = int(rank)
        self.alpha = float(alpha)
        if self.rank < 1:
            raise InvalidArgumentError(
                f"adapter {self.name!r}: rank must be >= 1, got {rank}")
        if not sites:
            raise InvalidArgumentError(
                f"adapter {self.name!r}: needs >= 1 site")
        checked = {}
        for site, (a, b) in sites.items():
            a = np.asarray(a)
            b = np.asarray(b)
            if a.ndim != 2 or b.ndim != 2 or a.shape[1] != self.rank or \
                    b.shape[0] != self.rank:
                raise InvalidArgumentError(
                    f"adapter {self.name!r} site {site!r}: expected "
                    f"A [in, {self.rank}] / B [{self.rank}, out], got "
                    f"A{a.shape} / B{b.shape}")
            checked[str(site)] = (a, b)
        self.sites = checked

    @property
    def scale(self) -> float:
        return self.alpha / float(self.rank)

    def __repr__(self):
        return (f"LoraAdapter({self.name!r}, rank={self.rank}, "
                f"alpha={self.alpha}, sites={len(self.sites)})")


def random_adapter(model, name: str, *, rank: int = 4, alpha: float = None,
                   targets: Sequence[str] = DEFAULT_TARGETS, seed: int = 0,
                   std: float = 0.02) -> LoraAdapter:
    """Seeded random adapter over the model's LoRA target sites, drawn
    from ``np.random.RandomState(seed)`` site by site (A, then B) in the
    JAX package's order: both packages make the same adapter from the
    same seed.

    Both A and B are nonzero (unlike training init, where B starts at
    zero) so the delta is observable."""
    rs = np.random.RandomState(seed)
    sites = {}
    for n, layer in lora_targets(model, targets):
        din, dout = (int(s) for s in layer.weight.shape)
        sites[n] = (
            rs.normal(0.0, std, (din, rank)).astype(np.float32),
            rs.normal(0.0, std, (rank, dout)).astype(np.float32),
        )
    if not sites:
        raise InvalidArgumentError(
            f"random_adapter: no LoRA targets matching {tuple(targets)!r}")
    return LoraAdapter(name, rank,
                       float(alpha) if alpha is not None else float(rank),
                       sites)


def merge_adapter(model, adapter: LoraAdapter) -> Dict[str, torch.Tensor]:
    """Dense-merged reference: the model's parameters by dotted name, with
    ``W + (A @ B) * scale`` folded into each adapter site's weight
    (float64 arithmetic, cast back to the weight's dtype, as the JAX
    package computes it; the other parameters are the model's own
    tensors).

    Binding this dict (``torch.func.functional_call(model, merged,
    args)``) gives the single-adapter dense forward the batched path is
    tested against (allclose, not bitwise: ``x@(W + AB)`` and ``x@W +
    (x@A)@B`` associate differently)."""
    params = {k: v.detach() for k, v in model.named_parameters()}
    for site, (a, b) in adapter.sites.items():
        wk = site + ".weight"
        if wk not in params:
            raise InvalidArgumentError(
                f"merge_adapter: model has no weight at site {site!r}")
        w = params[wk]
        delta = (a.astype(np.float64) @ b.astype(np.float64)) * adapter.scale
        params[wk] = (w.double() + torch.from_numpy(delta).to(w.device)
                      ).to(w.dtype)
    return params


def export_adapter(adapter: LoraAdapter, path: str) -> str:
    """Write ``<path>.pdlora`` (the serialized adapter payload) plus a
    ``<path>.pdlora.manifest.json`` sidecar with the artifact's sha256 —
    the integrity convention of the quantized-weight exports.  Returns the
    ``.pdlora`` path."""
    import json
    import os

    from ..framework import serialization
    from ..slim.quantization import _sha256

    path = os.fspath(path)
    prefix = path[:-7] if path.endswith(".pdlora") else path
    artifact = prefix + ".pdlora"
    payload = {
        "format": ADAPTER_FORMAT,
        "name": adapter.name,
        "rank": adapter.rank,
        "alpha": adapter.alpha,
        "sites": {s: {"A": np.asarray(a), "B": np.asarray(b)}
                  for s, (a, b) in adapter.sites.items()},
    }
    serialization.save(payload, artifact)
    manifest = {
        "format": ADAPTER_FORMAT,
        "name": adapter.name,
        "rank": adapter.rank,
        "alpha": adapter.alpha,
        "file": os.path.basename(artifact),
        "sha256": _sha256(artifact),
        "num_sites": len(adapter.sites),
    }
    mpath = artifact + ".manifest.json"
    tmp = mpath + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
    os.replace(tmp, mpath)
    return artifact


def load_adapter(path: str) -> LoraAdapter:
    """Load an exported adapter, verifying the manifest's sha256 against
    the artifact bytes (a missing or mismatched manifest is an error — the
    side file IS the integrity contract)."""
    import json
    import os

    from ..framework import serialization
    from ..slim.quantization import _sha256

    path = os.fspath(path)
    artifact = path if path.endswith(".pdlora") else path + ".pdlora"
    mpath = artifact + ".manifest.json"
    if not os.path.exists(mpath):
        raise InvalidArgumentError(
            f"load_adapter: no manifest at {mpath} — refusing an "
            f"unverifiable artifact")
    with open(mpath) as f:
        manifest = json.load(f)
    if manifest.get("format") != ADAPTER_FORMAT:
        raise InvalidArgumentError(
            f"load_adapter: {mpath} format is "
            f"{manifest.get('format')!r}, expected {ADAPTER_FORMAT!r}")
    digest = _sha256(artifact)
    if digest != manifest.get("sha256"):
        raise InvalidArgumentError(
            f"load_adapter: sha256 mismatch for {artifact}: manifest "
            f"says {manifest.get('sha256')}, file is {digest}")
    payload = serialization.load(artifact)
    if not isinstance(payload, dict) or payload.get("format") != \
            ADAPTER_FORMAT:
        raise InvalidArgumentError(
            f"load_adapter: {artifact} is not a "
            f"{ADAPTER_FORMAT!r} payload")
    sites = {s: (np.asarray(ab["A"]), np.asarray(ab["B"]))
             for s, ab in payload["sites"].items()}
    return LoraAdapter(payload["name"], payload["rank"], payload["alpha"],
                       sites)
